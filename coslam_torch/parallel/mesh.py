"""The camera mesh: the port of ``coslam_tpu/parallel/mesh.py``.

The JAX package's mesh is a ``jax.sharding.Mesh`` over one "cam" axis,
driven by one controller. The port keeps the single controller: a
``CamMesh`` is an ordered list of devices, one camera block a device, and
the one Python process that owns it drives them all. The layout is the
JAX package's "shard pixels, replicate points": the pixel work of each
camera block (pyramid, KLT and corner refill, NCC blocks) runs on that
block's device, and everything the JAX package replicates is computed
once, on the mesh's first device (``main``), where the state lives.

Every tensor the mesh code moves between its devices goes through
``CamMesh.scatter`` (main to the shards) or ``CamMesh.gather`` (the
shards to main), which count it by direction and leaf name in
``CamMesh.census``: the port's counterpart of the JAX package's
collective census (``coslam_tpu/parallel/scaling.py``). A transfer is
counted where the mesh code makes it, also when the two devices are the
same and the copy costs nothing.

A mesh may name one device more than once (``["cuda:0"] * 5`` on one
card, ``["cpu"] * 8`` in the tests), which a JAX mesh forbids: the
sharded code then runs, and is counted, on one device.
"""

from __future__ import annotations

import contextlib
from collections import Counter

import torch

from coslam_torch.util import resolve_device

TO_SHARD, TO_MAIN = "to_shard", "to_main"


class CamMesh:
    """An ordered list of devices, one camera block each; ``main`` (the
    first) holds the state and runs every replicated stage."""

    def __init__(self, devices):
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.census: Counter = Counter()   # (direction, leaf) -> transfers

    def __len__(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return f"CamMesh({[str(d) for d in self.devices]})"

    @property
    def main(self) -> torch.device:
        return self.devices[0]

    def blocks(self, n: int) -> list[slice]:
        """The contiguous block of ``n`` items (cameras, observations,
        points) each device takes, as ``PartitionSpec("cam")`` splits
        them. ``n`` must be divisible by the mesh size, as ``shard_map``
        requires."""
        k = len(self.devices)
        if n % k:
            raise ValueError(f"{n} items do not divide over a mesh of {k} "
                             "devices")
        b = n // k
        return [slice(i * b, (i + 1) * b) for i in range(k)]

    def scatter(self, x, leaf: str, dim: int = 0) -> list[torch.Tensor]:
        """Move to each device its part: ``x`` a tensor on main, split into
        contiguous blocks along ``dim``; or a list with one tensor per
        device (a value every shard needs is passed as ``[v] * len(mesh)``).
        Returns the parts, part k on ``devices[k]``."""
        if torch.is_tensor(x):
            parts = [x[(slice(None),) * dim + (b,)]
                     for b in self.blocks(x.shape[dim])]
        else:
            parts = list(x)
            if len(parts) != len(self.devices):
                raise ValueError(f"{len(parts)} parts for a mesh of "
                                 f"{len(self.devices)} devices")
        self.census[(TO_SHARD, leaf)] += len(parts)
        return [p.to(d, non_blocking=True)
                for p, d in zip(parts, self.devices)]

    def gather(self, parts, leaf: str) -> list[torch.Tensor]:
        """Move each device's part to main. Returns the parts, in device
        order, for the caller to concatenate or sum."""
        parts = list(parts)
        if len(parts) != len(self.devices):
            raise ValueError(f"{len(parts)} parts for a mesh of "
                             f"{len(self.devices)} devices")
        self.census[(TO_MAIN, leaf)] += len(parts)
        return [p.to(self.main, non_blocking=True) for p in parts]

    def reset_census(self):
        self.census.clear()


def on_device(device: torch.device):
    """Make ``device`` current while a shard's work is enqueued (a card's
    kernels and new tensors then land on it); nothing for the CPU."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def make_cam_mesh(n: int | None = None, devices=None) -> CamMesh:
    """A mesh over ``devices`` as given (repeats allowed), or over the
    first ``n`` visible CUDA devices (all of them when ``n`` is None).
    Raises when there are fewer CUDA devices than asked for: there is no
    fallback to the CPU."""
    if devices is not None:
        devices = list(devices)
        if n is not None:
            if n > len(devices):
                raise ValueError(f"need {n} devices, {len(devices)} given")
            devices = devices[:n]
        return CamMesh(devices)
    have = torch.cuda.device_count()
    n = have if n is None else n
    if n < 1 or have < n:
        raise RuntimeError(f"need {max(n, 1)} CUDA devices, have {have}; "
                           "pass devices= for a mesh of other devices")
    return CamMesh([f"cuda:{i}" for i in range(n)])


def round_robin(n: int, device=None) -> list[str]:
    """``n`` mesh devices: the visible cards round robin (``["cuda:0"] * n``
    on one card), or ``device`` repeated when it names another device
    (``["cpu"] * n``). Raises without a card unless ``device`` is given."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return [str(dev)] * n
    count = torch.cuda.device_count()
    return [f"cuda:{k % count}" for k in range(n)]


def shard_state(state, mesh: CamMesh):
    """A SlamState (or any tree of its NamedTuples) on the mesh: every leaf
    on ``mesh.main``, the port's counterpart of the JAX package's fully
    replicated ``state_pspecs``."""
    from coslam_torch.slam.state import _map_tree
    return _map_tree(lambda a: a.to(mesh.main), state)
