"""Meshes of shards, driven from one process.

A :class:`Mesh` is what the reference's ``jax.sharding.Mesh`` is to its
``shard_map`` programs: a grid of shards with named axes, e.g. 8 shards as
(data=4, model=2). Each position of the grid holds a ``torch.device``, and
devices may repeat: a (4, 2) mesh on ``cuda:0`` runs every tile and every
collective of a sharded algorithm on one card, as the reference's
``--xla_force_host_platform_device_count=8`` does on the CPU. One process
drives every shard; there is no process group.

The collectives over a set of axes are plain tensor operations on the
shards' tensors, given in flat shard order (row-major over the axes):
:func:`psum` adds them in that order, :func:`all_gather` concatenates them,
:func:`psum_scatter` adds and slices, leaving slice i on shard i's device
as the reference's tiled reduce-scatter leaves it on shard i. A shard's
tensor is copied (``Tensor.to``) only where its device differs from the
result's. The summation order is fixed, so a reduction repeats bit for
bit.

``make_cpu_mesh(n)`` and ``make_device_mesh(n)`` arrange n shards as the
most-square (rows, cols) factorization with rows >= cols (8 gives (4, 2)),
as the reference's ``make_cpu_mesh`` does; unlike it they never degrade,
since shards need no devices of their own. ``make_production_mesh`` builds
the reference's production shapes, (16, 16) or (2, 16, 16), on ``meta`` by
default: the dry-run resolves shardings on it and never allocates. The
reference's TPU v5e constants give way to the H100's data-sheet peaks
(``CARD_PEAKS``, ``PEAK_FLOPS_BF16``, ``HBM_BANDWIDTH``, ``HBM_BYTES``),
which ``launch/roofline.py`` and the card smoke read.
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
                     device="cuda") -> Mesh:
    """n shards on one device, as the most-square (rows, cols) grid with
    rows >= cols: the card's mesh (8 gives (4, 2))."""
    if n < 1:
        raise ValueError(f"need at least one shard, got {n}")
    return make_mesh(_square(n), axes, device=device)


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


def card_peaks(name: str) -> tuple[float, float, float, float]:
    """``CARD_PEAKS`` of the card named ``name``."""
    for key, rates in CARD_PEAKS.items():
        if key in name:
            return rates
    raise RuntimeError(f"no published peaks for card {name!r}")


# -- collectives: the shards' tensors in flat shard order ----------------------

def psum(parts: Sequence[torch.Tensor], device=None) -> torch.Tensor:
    """Sum of the shards' tensors, added in flat shard order on ``device``
    (default: the first shard's)."""
    dev = parts[0].device if device is None else torch.device(device)
    total = parts[0].to(dev)
    for p in parts[1:]:
        total = total + p.to(dev)
    return total


def all_gather(parts: Sequence[torch.Tensor], device=None,
               dim: int = 0) -> torch.Tensor:
    """The shards' tensors concatenated along ``dim`` (a tiled all-gather)."""
    dev = parts[0].device if device is None else torch.device(device)
    return torch.cat([p.to(dev) for p in parts], dim=dim)


def psum_scatter(parts: Sequence[torch.Tensor], device=None,
                 dim: int = 0) -> list[torch.Tensor]:
    """:func:`psum` on ``device``, then the sum cut into ``len(parts)`` equal
    slices along ``dim`` (a tiled reduce-scatter): slice i goes to shard i's
    device, ``parts[i].device``."""
    total = psum(parts, device)
    if total.shape[dim] % len(parts):
        raise ValueError(f"dim {dim} of size {total.shape[dim]} does not "
                         f"split into {len(parts)} shards")
    return [s.to(p.device) for s, p in zip(torch.chunk(total, len(parts), dim=dim), parts)]
