"""Logical-axis sharding rules (MaxText-style) with divisibility fallbacks.

Code annotates tensors with *logical* axis names (a :class:`PartitionSpec`
over names like "embed", "heads", "gram_row"); :meth:`ShardingRules.resolve`
turns one into mesh axes:

  * each logical name has an ordered list of candidate mesh axes (possibly
    composite, e.g. batch -> ("pod", "data"));
  * a candidate is taken only if the dimension is divisible by the product
    of its mesh axes' sizes (and that product exceeds 1) and none of those
    axes is already used by an earlier dimension of the same tensor;
    otherwise the next candidate, or replication, applies.

The rule tables are the reference's, as plain data. ``FUSION_RULES`` lays out
the sharded fusion server's Gram (``server.distributed``): rows over the
client axes, columns over the model axis. The model-parameter tables
(``DEFAULT_RULES``, ``ZERO1_PARAM_RULES``, ``STACK_FSDP_RULES``,
``DECODE_RULES``, ``BATCH_AXES``) lay out a model's parameters, optimizer
state, batches and caches: :meth:`ShardingRules.named` gives a
:class:`NamedSharding` (a mesh and a resolved spec, with ``shard_shape``),
:meth:`ShardingRules.tree_shardings`, :func:`params_shardings` and
:func:`opt_state_shardings` one for every leaf of a tree of logical specs
(``models.model.param_axes``) over a tree of the same structure (nested
dicts and tuples) whose leaves are tensors (``meta`` ones will do) or
shapes.

:class:`ShardedTensor` is a tensor laid out over a mesh by a spec: one block
per shard position, on that shard's device (the reference's array with a
``NamedSharding``). ``checkpoint.load_pytree`` restores onto one.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Sequence

import torch

from repro_torch.launch import mesh as mesh_lib

Candidate = tuple[str, ...]


class PartitionSpec(tuple):
    """Per-dimension entries: None (replicated), a mesh axis name, or a tuple
    of axis names (the reference's ``jax.sharding.PartitionSpec``)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def spec_axes(entry) -> tuple[str, ...]:
    """The mesh axes of one spec entry (None -> ())."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def spec_entry(axes: Sequence[str]):
    """A spec entry for an axis tuple (singletons unwrapped, () -> None)."""
    axes = tuple(axes)
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else axes


def map_specs(fn, tree, *others):
    """``fn(spec, *leaves)`` for every spec of ``tree`` (nested dicts,
    tuples and lists whose leaves are specs), with the leaves at the same
    place in each of ``others``, in a tree of ``tree``'s structure."""
    if isinstance(tree, PartitionSpec):
        return fn(tree, *others)
    if isinstance(tree, dict):
        for o in others:
            if set(o) != set(tree):
                raise ValueError(f"tree keys {sorted(o)} differ from {sorted(tree)}")
        return {k: map_specs(fn, v, *(o[k] for o in others)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        for o in others:
            if len(o) != len(tree):
                raise ValueError(f"a sequence of {len(o)} against {len(tree)}")
        return type(tree)(map_specs(fn, v, *(o[i] for o in others))
                          for i, v in enumerate(tree))
    raise TypeError(f"not a spec tree node: {tree!r}")


def _shape(leaf) -> tuple[int, ...]:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf)


def _cands(*names) -> tuple[Candidate, ...]:
    return tuple((n,) if isinstance(n, str) else tuple(n) for n in names)


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Ordered mesh-axis candidates per logical axis name."""

    rules: Mapping[str, tuple[Candidate, ...]]

    def resolve(self, logical: Sequence, shape: Sequence[int], mesh
                ) -> PartitionSpec:
        """Mesh axes for each dimension of a tensor of ``shape`` annotated
        with ``logical`` (a mesh on the ``meta`` device will do)."""
        used: set[str] = set()
        out = []
        names = tuple(logical) + (None,) * (len(shape) - len(logical))
        for dim, name in zip(shape, names):
            chosen: Candidate | None = None
            for cand in self.rules.get(name, ()) if name else ():
                axes = tuple(a for a in cand
                             if a in mesh.axis_names and a not in used)
                if not axes:
                    continue
                prod = math.prod(mesh.shape[a] for a in axes)
                if prod > 1 and dim % prod == 0:
                    chosen = axes
                    used.update(axes)
                    break
            out.append(None if chosen is None else spec_entry(chosen))
        return PartitionSpec(*out)

    def named(self, logical: Sequence, shape: Sequence[int], mesh) -> "NamedSharding":
        return NamedSharding(mesh, self.resolve(logical, shape, mesh))

    def tree_shardings(self, axes_tree, shape_tree, mesh):
        """A :class:`NamedSharding` for every leaf of ``shape_tree``
        (tensors or shapes), by the spec at its place in ``axes_tree``."""
        return map_specs(lambda spec, leaf: self.named(spec, _shape(leaf), mesh),
                         axes_tree, shape_tree)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh and a resolved spec (the reference's ``jax.sharding.NamedSharding``)."""

    mesh: object
    spec: PartitionSpec

    def shard_shape(self, shape: Sequence[int]) -> tuple[int, ...]:
        """The shape of one shard's block of a tensor of ``shape``."""
        counts = ShardedTensor.grid(self.mesh, self.spec, shape)
        return tuple(int(d) // n for d, n in zip(shape, counts))


def params_shardings(rules: ShardingRules, axes_tree, params_shapes, mesh):
    return rules.tree_shardings(axes_tree, params_shapes, mesh)


def opt_state_shardings(rules: ShardingRules, axes_tree, opt_shapes, mesh):
    """Optimizer state mirrors the parameters' sharding (master / m / v);
    the step count is replicated."""
    out = {k: rules.tree_shardings(axes_tree, opt_shapes[k], mesh)
           for k in ("master", "m", "v")}
    out["count"] = NamedSharding(mesh, PartitionSpec())
    return out


DEFAULT_RULES = ShardingRules(rules={
    # data / activations
    "batch": _cands(("pod", "data"), ("data",)),
    "seq": _cands(),
    "seq_cache": _cands(),
    # parameters
    "embed": _cands(("data",)),            # FSDP over the data axis
    "vocab": _cands(("model",)),
    "heads": _cands(("model",)),
    "kv": _cands(("model",)),
    "kv_heads": _cands(("model",)),
    "head_dim": _cands(("model",)),        # fallback when kv_heads indivisible
    "ff": _cands(("model",)),
    "experts": _cands(("model",)),
    "inner": _cands(("model",)),           # mamba d_inner
    "state": _cands(),
    "rwkv_heads": _cands(("model",)),
    "stack": _cands(),                     # stacked-stage dim: never sharded
    # activation head axes
    "heads_act": _cands(("model",)),
    "head_dim_act": _cands(("model",)),
})

# The sharded fusion server's Gram: rows over the client / data axes (where
# the Phase-2 reduction lives), columns over the model axis; its Cholesky
# factor keeps the layout. h stays replicated. On a mesh axis of size 1 (or
# an indivisible padded dim, which the backend prevents by padding to the
# axes' lcm) a dimension falls back to replication.
FUSION_RULES = ShardingRules(rules={
    "gram_row": _cands(("pod", "data"), ("data",)),
    "gram_col": _cands(("model",)),
})

GRAM_AXES = P("gram_row", "gram_col")

# bf16 compute weights model-sharded only; the float32 master / m / v shard
# over 'data' through their 'embed' dimension instead.
ZERO1_PARAM_RULES = ShardingRules(rules={
    **DEFAULT_RULES.rules, "embed": _cands(),
})

# The stacked-stage leading axis over 'data', 'embed' dropped from weights.
STACK_FSDP_RULES = ShardingRules(rules={
    **DEFAULT_RULES.rules, "embed": _cands(), "stack": _cands(("data",)),
})

# Decode: weights fully sharded and resident; the spare data axis takes the
# expert FFN dim when 'model' is taken by 'experts'.
DECODE_RULES = ShardingRules(rules={
    **DEFAULT_RULES.rules,
    "embed": _cands(),
    "ff": _cands(("model",), ("data",)),
})

# Logical specs of the input batches (per input mode).
BATCH_AXES = {
    "tokens": {"tokens": P("batch", "seq"), "labels": P("batch", "seq")},
    "embeddings": {"embeddings": P("batch", "seq", "embed"),
                   "labels": P("batch", "seq"), "mask": P("batch", "seq")},
    "prefix_embeddings": {"tokens": P("batch", "seq"),
                          "labels": P("batch", "seq"),
                          "patches": P("batch", "seq", "embed")},
}


class ShardedTensor:
    """A tensor of ``shape`` laid out over ``mesh`` by ``spec``: each shard
    position holds its block (the slice its coordinates select along every
    sharded dimension), on that shard's device.

    Blocks are keyed by the tuple of per-dimension block indices; shards
    that differ only along mesh axes the spec does not use share one block,
    kept on the device of the first of them in flat order.
    """

    def __init__(self, mesh, spec: Sequence, shape: Sequence[int],
                 blocks: Mapping[tuple[int, ...], torch.Tensor]):
        self.mesh = mesh
        self.spec = PartitionSpec(*tuple(spec) + (None,) * (len(shape) - len(spec)))
        self.shape = tuple(int(s) for s in shape)
        self.blocks = dict(blocks)
        first = next(iter(self.blocks.values()))
        self.dtype = first.dtype

    @staticmethod
    def grid(mesh, spec: Sequence, shape: Sequence[int]) -> list[int]:
        """Blocks along each dimension (the product of its axes' sizes)."""
        spec = tuple(spec) + (None,) * (len(shape) - len(spec))
        counts = [mesh_lib.axis_size(mesh, spec_axes(e)) for e in spec]
        for dim, n in zip(shape, counts):
            if dim % n:
                raise ValueError(f"dimension {dim} does not split into {n} "
                                 f"blocks (spec {spec})")
        return counts

    @classmethod
    def distribute(cls, x: torch.Tensor, mesh, spec: Sequence | None = None
                   ) -> "ShardedTensor":
        """Cut ``x`` into the spec's blocks and copy each from ``x``'s
        device straight to its shard's (``launch.mesh.send``), block by
        block; ``mesh`` may be a :class:`NamedSharding` (and ``spec`` then
        omitted)."""
        if isinstance(mesh, NamedSharding):
            if spec is not None:
                raise ValueError("a NamedSharding carries its spec")
            mesh, spec = mesh.mesh, mesh.spec
        counts = cls.grid(mesh, spec, x.shape)
        spec = tuple(spec) + (None,) * (x.ndim - len(spec))
        blocks = {}
        for index in _indices(counts):
            sl = tuple(slice(i * (s // n), (i + 1) * (s // n))
                       for i, s, n in zip(index, x.shape, counts))
            coords = {}
            for i, entry in zip(index, spec):
                coords.update(mesh_lib.unflatten(mesh, spec_axes(entry), i))
            blocks[index] = mesh_lib.send(x[sl], mesh.device_at(coords), copy=True)
        return cls(mesh, spec, x.shape, blocks)

    def full(self, device=None) -> torch.Tensor:
        """The whole tensor on ``device`` (default: the first block's),
        each block copied straight there from its shard's device."""
        counts = self.grid(self.mesh, self.spec, self.shape)
        dev = next(iter(self.blocks.values())).device if device is None \
            else torch.device(device)

        def assemble(prefix: tuple[int, ...]) -> torch.Tensor:
            d = len(prefix)
            if d == len(counts):
                return mesh_lib.send(self.blocks[prefix], dev)
            return torch.cat([assemble(prefix + (i,)) for i in range(counts[d])],
                             dim=d)

        return assemble(())

    @property
    def nbytes(self) -> int:
        return sum(b.numel() * b.element_size() for b in self.blocks.values())

    def __repr__(self) -> str:
        return (f"ShardedTensor(shape={self.shape}, dtype={self.dtype}, "
                f"spec={self.spec}, mesh={self.mesh.shape})")


def _indices(counts: Sequence[int]):
    if not counts:
        yield ()
        return
    for i in range(counts[0]):
        for rest in _indices(counts[1:]):
            yield (i,) + rest
