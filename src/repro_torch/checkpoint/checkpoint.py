"""Pytree checkpointing: npz arrays plus a JSON manifest, one pair a step.

A tree is nested dicts, lists and tuples whose leaves are tensors, numpy
arrays or scalars. Leaves go to the host, are keyed by the path the JAX
package's ``jax.tree_util.keystr`` gives them (``['t0']['fused']['gram']``;
dict keys sorted, a sequence position as ``[0]``, ``None`` holds no leaf),
and are written as one ``.npz`` per step plus a manifest. So a step written
by either package loads in the other. Restore rebuilds the template's
structure, casts every leaf onto the template leaf's dtype and puts it on
``device``; a ``launch.sharding.ShardedTensor`` template leaf is restored
onto its mesh and spec instead (the reference's restore onto a sharded
template), and a ``ShardedTensor`` leaf is saved whole.
"""
from __future__ import annotations

import json
import os
import pathlib
import re

import numpy as np
import torch

from repro_torch.launch.sharding import ShardedTensor


def _paths(tree, prefix: str = ""):
    """(keystr, leaf) pairs in the JAX package's flattening order."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], f"{prefix}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            yield from _paths(sub, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def _rebuild(tree, fn, prefix: str = ""):
    """``tree`` with every leaf replaced by ``fn(keystr, leaf)``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _rebuild(v, fn, f"{prefix}[{k!r}]") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_rebuild(v, fn, f"{prefix}[{i}]") for i, v in enumerate(tree)]
        return type(tree)(out)
    return fn(prefix, tree)


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, ShardedTensor):
        leaf = leaf.full("cpu")
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach()
        if leaf.dtype in (torch.bfloat16, torch.float16):
            # numpy has no bf16, and the JAX package widens its ml_dtypes
            # leaves to float32: every such value embeds exactly, and
            # load_pytree casts back onto the template's dtype
            leaf = leaf.float()
        return leaf.cpu().numpy()
    return np.asarray(leaf)


def _flatten(tree) -> dict[str, np.ndarray]:
    return {key: _host(leaf) for key, leaf in _paths(tree)}


def _write_durable(path: pathlib.Path, writer) -> None:
    """tmp -> flush -> fsync -> rename: ``path`` either holds the complete
    new contents or does not exist; no reader ever sees a torn file."""
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "wb") as f:
        writer(f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def save_pytree(tree, directory: str | pathlib.Path, step: int) -> pathlib.Path:
    """Write one step's arrays + manifest, crash-safely.

    Both files go through tmp -> fsync -> rename, so ``load_pytree`` (and
    ``server.durability``'s ``load_snapshot``) never observes a half-written
    ``step_<seq>.npz``. Callers that need the rename itself to survive power
    loss (``DurableStore.commit_snapshot``) also fsync the directory.
    """
    d = pathlib.Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    arrays = _flatten(tree)
    path = d / f"step_{step:08d}.npz"
    _write_durable(path, lambda f: np.savez(f, **arrays))
    manifest = {"step": step, "num_leaves": len(arrays),
                "keys": sorted(arrays)}
    _write_durable(d / f"step_{step:08d}.json",
                   lambda f: f.write(json.dumps(manifest).encode()))
    return path


def latest_step(directory: str | pathlib.Path) -> int | None:
    d = pathlib.Path(directory)
    steps = [int(m.group(1)) for p in d.glob("step_*.npz")
             if (m := re.match(r"step_(\d+)\.npz", p.name))]
    return max(steps) if steps else None


def _torch_dtype(leaf) -> torch.dtype | None:
    dt = getattr(leaf, "dtype", None)
    if dt is None or isinstance(dt, torch.dtype):
        return dt
    return torch.from_numpy(np.zeros(0, dt)).dtype


def load_pytree(template, directory: str | pathlib.Path, step: int, *,
                device="cuda"):
    """Restore into the structure of ``template``: each leaf becomes a tensor
    on ``device`` in the template leaf's dtype (a leaf without a dtype keeps
    the saved one). A template leaf may be a tensor on the ``meta`` device,
    which costs no memory. A ``ShardedTensor`` template leaf gives a
    ``ShardedTensor`` on the template's mesh and spec, each block on its
    shard's device (``device`` is not used for it)."""
    d = pathlib.Path(directory)
    with np.load(d / f"step_{step:08d}.npz") as data:
        def leaf(key, t):
            x = torch.from_numpy(data[key])
            if isinstance(t, ShardedTensor):
                if tuple(x.shape) != t.shape:
                    raise ValueError(f"{key}: saved shape {tuple(x.shape)}, "
                                     f"template {t.shape}")
                return ShardedTensor.distribute(x.to(t.dtype), t.mesh, t.spec)
            return x.to(device=device, dtype=_torch_dtype(t))

        return _rebuild(template, leaf)
