"""Meshes of shards, driven from one process.

A :class:`Mesh` is what the reference's ``jax.sharding.Mesh`` is to its
``shard_map`` programs: a grid of shards with named axes, e.g. 8 shards as
(data=4, model=2). Each position of the grid holds a ``torch.device``, and
devices may repeat: a (4, 2) mesh on ``cuda:0`` runs every tile and every
collective of a sharded algorithm on one card, as the reference's
``--xla_force_host_platform_device_count=8`` does on the CPU, and
``make_device_mesh(8, devices=[cuda:0, ..., cuda:3])`` puts row i of the
(4, 2) mesh on card i. One process drives every shard; there is no process
group.

The collectives over a set of axes are plain tensor operations on the
shards' tensors, given in flat shard order (row-major over the axes), with
peer copies (``Tensor.to``) between devices:

  * :func:`psum_scatter` adds slice j of every part on slice j's device
    (shard j's by default), as the reference's tiled reduce-scatter leaves
    it on shard j: each device receives only the slices it owns;
  * :func:`psum` adds the parts onto one device, or, for several consumer
    devices, reduce-scatters and then all-gathers the slices onto each;
  * :func:`all_gather` concatenates the parts on each consumer device;
  * :func:`broadcast` copies one tensor to each consumer device.

Every sum is taken in flat shard order, elementwise, so its bits are those
of the one-device mesh whatever the placement. A tensor is copied only
where its device differs from the one that needs it, and each collective
counts the bytes it moved between distinct devices (``moved_bytes``, read
by :func:`collective_bytes`), as each kernel wrapper counts its launches.

``make_cpu_mesh(n)`` and ``make_device_mesh(n)`` arrange n shards as the
most-square (rows, cols) factorization with rows >= cols (8 gives (4, 2)),
as the reference's ``make_cpu_mesh`` does; unlike it they never degrade,
since shards need no devices of their own. ``make_production_mesh`` builds
the reference's production shapes, (16, 16) or (2, 16, 16), on ``meta`` by
default: the dry-run resolves shardings on it and never allocates. The
reference's TPU v5e constants give way to the H100's data-sheet peaks
(``CARD_PEAKS``, ``PEAK_FLOPS_BF16``, ``HBM_BANDWIDTH``, ``HBM_BYTES``,
``NVLINK_BANDWIDTH``), which ``launch/roofline.py`` and the card smoke read.
"""
from __future__ import annotations

import math
from typing import Mapping, Sequence

import numpy as np
import torch


def _device(dev) -> torch.device:
    """``dev`` as a torch.device, a CUDA one with its index filled in (the
    current device), so that it equals the device its tensors report."""
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """A named-axis grid of shards, each with its ``torch.device``."""

    def __init__(self, devices, axis_names: Sequence[str]):
        grid = np.empty(np.shape(devices), dtype=object)
        for idx in np.ndindex(grid.shape):
            grid[idx] = _device(np.asarray(devices, dtype=object)[idx])
        if grid.ndim != len(axis_names):
            raise ValueError(f"mesh of {grid.ndim} dims, {len(axis_names)} "
                             f"axis names {tuple(axis_names)}")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"repeated axis names {tuple(axis_names)}")
        self.devices = grid
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict[str, int]:
        """Axis name -> size, in axis order (the reference's ``mesh.shape``)."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def distinct_devices(self) -> list[torch.device]:
        """Every device of the mesh once, in flat shard order."""
        out: list[torch.device] = []
        for dev in self.devices.flat:
            if dev not in out:
                out.append(dev)
        return out

    def device_at(self, coords: Mapping[str, int]) -> torch.device:
        """The device of the shard at ``coords`` (axes not named: index 0)."""
        return self.devices[tuple(coords.get(a, 0) for a in self.axis_names)]

    def __repr__(self) -> str:
        devs = ", ".join(map(str, self.distinct_devices))
        return f"Mesh({self.shape}, devices [{devs}])"


def axis_size(mesh, axes: Sequence[str]) -> int:
    """Product of the sizes of ``axes`` (1 for none)."""
    return math.prod(mesh.shape[a] for a in axes)


def unflatten(mesh, axes: Sequence[str], flat: int) -> dict[str, int]:
    """Coordinates along ``axes`` of flat (row-major) position ``flat``."""
    coords = {}
    for ax in reversed(tuple(axes)):
        flat, coords[ax] = divmod(flat, mesh.shape[ax])
    return coords


def _square(n: int) -> tuple[int, int]:
    cols = max(c for c in range(1, math.isqrt(n) + 1) if n % c == 0)
    return n // cols, cols


def make_mesh(shape: Sequence[int], axes: Sequence[str], *,
              device="cuda") -> Mesh:
    """A mesh of ``shape`` whose every shard sits on ``device``."""
    dev = _device(device)
    grid = np.empty(tuple(shape), dtype=object)
    for idx in np.ndindex(grid.shape):
        grid[idx] = dev
    return Mesh(grid, axes)


def make_device_mesh(n: int = 8, axes=("data", "model"), *,
                     device="cuda", devices=None) -> Mesh:
    """n shards as the most-square (rows, cols) grid with rows >= cols (8
    gives (4, 2)), all on ``device``; or, given ``devices`` (C of them),
    shard s of the flat order on ``devices[s * C // n]``, so that a device
    holds whole mesh rows where C divides the rows: the (4, 2) mesh on four
    cards puts row i on card i."""
    if n < 1:
        raise ValueError(f"need at least one shard, got {n}")
    if devices is None:
        return make_mesh(_square(n), axes, device=device)
    devs = [_device(d) for d in devices]
    if not 1 <= len(devs) <= n:
        raise ValueError(f"{len(devs)} devices for {n} shards")
    flat = np.empty(n, dtype=object)
    for s in range(n):
        flat[s] = devs[s * len(devs) // n]
    return Mesh(flat.reshape(_square(n)), axes)


def spread_devices(device="cuda") -> list[torch.device]:
    """The devices a mesh for ``device`` spreads over: every visible card
    for ``"cuda"`` with no index (as the reference's ``make_cpu_mesh``
    takes the host's devices), else ``device`` alone."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [_device(dev)]


def make_production_mesh(*, multi_pod: bool = False, device="meta") -> Mesh:
    """The reference's production mesh: (data 16, model 16), or with
    ``multi_pod`` (pod 2, data 16, model 16), every shard on ``device``."""
    if multi_pod:
        return make_mesh((2, 16, 16), ("pod", "data", "model"), device=device)
    return make_mesh((16, 16), ("data", "model"), device=device)


def make_host_mesh(shape=(4, 2), axes=("data", "model")) -> Mesh:
    """A mesh of ``shape`` on the CPU (tests)."""
    return make_mesh(shape, axes, device="cpu")


def make_cpu_mesh(n: int = 8, axes=("data", "model")) -> Mesh:
    """n shards on the CPU, most-square with rows >= cols."""
    return make_device_mesh(n, axes, device="cpu")


def client_axes(mesh) -> tuple[str, ...]:
    """Mesh axes that play the paper's 'clients' role (row-sharding axes)."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


# -- the card's peaks --------------------------------------------------------

# Published peaks, NVIDIA H100 data sheet (dense, without sparsity, at the
# full power limit): memory bytes/s, FP32 operations/s outside the tensor
# cores, dense bf16 tensor-core operations/s and dense TF32 tensor-core
# operations/s (a 3xTF32 route runs at a third of it), by the name's part
# that ``torch.cuda.get_device_name`` gives.
CARD_PEAKS = {
    "H100 PCIe": (2.0e12, 51e12, 756e12, 378e12),
    "H100 NVL": (3.9e12, 60e12, 835e12, 418e12),
    "H100": (3.35e12, 67e12, 989e12, 495e12),     # SXM5 (HBM3)
}

# The H100 SXM5 80 GB at 700 W, the roofline's target (data sheet):
PEAK_FLOPS_BF16 = 989e12          # FLOP/s, dense bf16 tensor cores
HBM_BANDWIDTH = 3.35e12           # bytes/s, HBM3
HBM_BYTES = 80e9                  # "80GB" of HBM3, as the data sheet states it
NVLINK_BANDWIDTH = 450e9          # bytes/s each way a card, fourth-generation NVLink


def card_peaks(name: str) -> tuple[float, float, float, float]:
    """``CARD_PEAKS`` of the card named ``name``."""
    for key, rates in CARD_PEAKS.items():
        if key in name:
            return rates
    raise RuntimeError(f"no published peaks for card {name!r}")


# -- collectives: the shards' tensors in flat shard order ----------------------

def _moved(t: torch.Tensor, dev: torch.device, collective) -> torch.Tensor:
    """``t`` on ``dev``: itself if it is there, else a peer copy whose bytes
    ``collective`` counts. A strided view is made contiguous on its own
    device first, so that the copy between devices is one block (a copy
    engine's memcpy, not a kernel of strided remote stores). Only a copy to
    the host blocks the host."""
    if t.device == dev:
        return t
    collective.moved_bytes += t.numel() * t.element_size()
    return t.contiguous().to(dev, non_blocking=dev.type == "cuda")


def _add(parts: Sequence[torch.Tensor], dev: torch.device, collective) -> torch.Tensor:
    """The parts added in flat shard order on ``dev``."""
    total = _moved(parts[0], dev, collective)
    for p in parts[1:]:
        total = total + _moved(p, dev, collective)
    return total


def _consumers(parts, device, devices) -> list[torch.device]:
    if devices is not None:
        return [_device(d) for d in devices]
    return [parts[0].device if device is None else _device(device)]


def _one_each(devs: Sequence[torch.device], make) -> list[torch.Tensor]:
    """``make(dev)`` once per distinct device, listed in ``devs``' order."""
    made: dict[torch.device, torch.Tensor] = {}
    return [made[d] if d in made else made.setdefault(d, make(d)) for d in devs]


def psum(parts: Sequence[torch.Tensor], device=None, *, devices=None):
    """Sum of the shards' tensors, added in flat shard order.

    On ``device`` (default: the first shard's), the parts moved there; or,
    with ``devices`` (the consumers), a list of one copy each: where the
    parts span devices, slice j of every part is added on part j's device
    (a reduce-scatter) and the slices are gathered onto each consumer.
    The adds are the same elementwise, so every copy has the one-device
    sum's bits."""
    devs = _consumers(parts, device, devices)
    spread = {p.device for p in parts} | set(devs)
    if devices is None or len(spread) == 1 or parts[0].ndim == 0:
        out = _one_each(devs, lambda d: _add(parts, d, psum))
        return out if devices is not None else out[0]
    n = len(parts)
    cuts = [p.tensor_split(n) for p in parts]
    slices = [_add([c[j] for c in cuts], parts[j].device, psum) for j in range(n)]
    return _one_each(devs, lambda d: torch.cat([_moved(s, d, psum) for s in slices]))


def all_gather(parts: Sequence[torch.Tensor], device=None, dim: int = 0, *,
               devices=None):
    """The shards' tensors concatenated along ``dim`` (a tiled all-gather)
    on ``device`` (default: the first shard's), or a list of one copy a
    device of ``devices``."""
    out = _one_each(_consumers(parts, device, devices), lambda d: torch.cat(
        [_moved(p, d, all_gather) for p in parts], dim=dim))
    return out if devices is not None else out[0]


def psum_scatter(parts: Sequence[torch.Tensor], dim: int = 0, *,
                 devices=None) -> list[torch.Tensor]:
    """The sum of the parts cut into ``len(parts)`` equal slices along
    ``dim`` (a tiled reduce-scatter): slice j, added in flat shard order on
    ``devices[j]`` (default shard j's device, ``parts[j].device``). Only
    slice j of each part moves to slice j's device, and no device holds the
    whole sum unless every part and slice is on it, where the slices are
    views of the one sum."""
    n = len(parts)
    if parts[0].shape[dim] % n:
        raise ValueError(f"dim {dim} of size {parts[0].shape[dim]} does not "
                         f"split into {n} shards")
    devs = ([_device(d) for d in devices] if devices is not None
            else [p.device for p in parts])
    if len({p.device for p in parts} | set(devs)) == 1:
        return list(torch.chunk(_add(parts, devs[0], psum_scatter), n, dim=dim))
    cuts = [torch.chunk(p, n, dim=dim) for p in parts]
    return [_add([c[j] for c in cuts], devs[j], psum_scatter) for j in range(n)]


def broadcast(x: torch.Tensor, devices) -> list[torch.Tensor]:
    """``x`` on each device of ``devices`` (itself where it already is)."""
    return _one_each([_device(d) for d in devices],
                     lambda d: _moved(x, d, broadcast))


def send(x: torch.Tensor, device, *, copy: bool = False) -> torch.Tensor:
    """``x`` on ``device``: a point-to-point copy (a block to its shard);
    with ``copy``, a contiguous tensor of its own even where ``x`` is
    already there."""
    out = _moved(x, _device(device), send)
    if copy and out.device == x.device:
        out = out.clone(memory_format=torch.contiguous_format)
    return out


COLLECTIVES = {"psum": psum, "all_gather": all_gather,
               "psum_scatter": psum_scatter, "broadcast": broadcast, "send": send}
for _fn in COLLECTIVES.values():
    _fn.moved_bytes = 0


def collective_bytes() -> dict[str, int]:
    """Bytes each collective moved between distinct devices since the last
    :func:`reset_collective_bytes`."""
    return {name: fn.moved_bytes for name, fn in COLLECTIVES.items()}


def reset_collective_bytes() -> None:
    for fn in COLLECTIVES.values():
        fn.moved_bytes = 0
