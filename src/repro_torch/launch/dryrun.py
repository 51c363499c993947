"""Dry-run of every (arch x input-shape x mesh) on the ``meta`` device.

The counterpart of the reference's ``launch/dryrun.py``, which lowers and
compiles each combination on 512 host placeholder devices and costs it
with XLA's analyses. Here every tensor is a ``meta`` tensor (shapes and
dtypes, no data, nothing allocated) from the port's own constructors
(``launch/specs.py``), and the meshes are grids of ``meta`` shards
(``mesh.make_production_mesh``, or with ``--card`` the (1, 1) mesh of one
H100). Per combination the record holds:

  memory mode — per-device bytes of the step's arguments, exact from the
                resolved shardings of the reference's stacked layout
                (``DEFAULT_RULES``): the parameters, AdamW's master / m / v
                and count for ``train``, the batch, the cache for
                ``decode``; the outputs' bytes likewise (``train``: loss,
                parameters and state; ``prefill``: last logits and the
                cache; ``decode``: logits and the cache; an encoder's
                prefill: all logits); ``fits`` (arguments within
                ``HBM_BYTES``) and, on ``--card``, the most whole stages
                whose arguments fit beside the embedding, head and tail
                (``fit_layers`` counts the tail's layers too).
                ``temp_bytes`` is null: no compiler plans the port's
                working set.
  cost mode   — FLOPs counted by ``torch.utils.flop_counter.FlopCounterMode``
                over the step run on ``meta`` at 2 and at 4 stages (the
                reference's extrapolation anchors, ``launch/roofline.py``),
                at the reference's cost settings: no remat, attention as
                one chunk (the plain attention reads all S keys in every
                query block), Mamba and RWKV at the port's chunk of 64.
                The count is the whole program's; divided by the mesh's
                devices it stands for the per-chip figure (XLA counts the
                per-device program after partitioning). HLO bytes do not
                exist here (null). Collective bytes (0 on the card) come
                from a second run of the same step on a mesh of more than
                one device, partitioned by DTensor's sharding propagation
                (:func:`count_collective_bytes`): the result bytes of every
                collective of rank 0's program, by the reference's kind
                names (its ``parse_collectives``), with the outputs laid
                out as the reference's ``out_shardings`` name them. An op
                DTensor cannot run sharded runs on operands replicated
                first, the replication counted, and is listed under
                ``replicated_ops``.

On ``meta`` the port's kernels take their plain versions, which compute
nothing there (``kernels.ops.on_card``): no kernel is launched.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-9b --shape train_4k [--card]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod | --card] [--memory-only]
Outputs JSON under experiments/dryrun_torch/.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import itertools
import json
import math
import pathlib
import time
import traceback
from unittest import mock

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor import placement_types
from torch.distributed.tensor.experimental import implicit_replication
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves, tree_map_only
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import configs
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import sharding, specs
from repro_torch.models import layers
from repro_torch.models import model as M
from repro_torch.models.attention import Attention
from repro_torch.models.config import INPUT_SHAPES, ArchConfig, InputShape, shape_applicable
from repro_torch.optim import adamw

OUT_DIR = pathlib.Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"
COST_STAGES = (2, 4)
LOGITS_AXES = sharding.P("batch", "seq", "vocab")     # the outputs' logits


def make_named_mesh(name: str) -> mesh_lib.Mesh:
    """``pod1`` (16 x 16), ``pod2`` (2 x 16 x 16) or ``card`` (1 x 1), on meta."""
    if name == "card":
        return mesh_lib.make_mesh((1, 1), ("data", "model"), device="meta")
    return mesh_lib.make_production_mesh(multi_pod=name == "pod2")


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def tree_bytes(rules: sharding.ShardingRules, axes, shapes, mesh) -> int:
    """Per-device bytes of a tree of meta tensors laid out by ``axes``."""
    def leaf_bytes(spec, t):
        return math.prod(rules.named(spec, t.shape, mesh).shard_shape(t.shape)) \
            * t.element_size()
    return sum(_leaves(sharding.map_specs(leaf_bytes, axes, shapes)))


def memory(cfg: ArchConfig, shape: InputShape, mesh,
           rules: sharding.ShardingRules = sharding.DEFAULT_RULES) -> dict:
    """Per-device argument and output bytes of ``shape``'s step (the
    module docstring's memory mode), by group, as integers."""
    p_axes = M.param_axes(cfg)
    params = tree_bytes(rules, p_axes, specs.params_specs(cfg), mesh)
    b_specs = specs.batch_specs(cfg, shape)
    b_axes = {k: sharding.BATCH_AXES[cfg.input_mode][k] for k in b_specs}
    args = {"params": params, "batch": tree_bytes(rules, b_axes, b_specs, mesh)}
    B, V = shape.global_batch, cfg.vocab_size
    act = torch.empty((), dtype=layers.dtype_of(cfg.dtype)).element_size()
    if shape.kind == "train":
        o = specs.opt_specs(cfg)
        opt = sum(tree_bytes(rules, p_axes, o[k], mesh) for k in ("master", "m", "v"))
        args["opt"] = opt + o["count"].element_size()
        outputs = 4 + params + args["opt"]                 # float32 loss
    elif shape.kind == "prefill" and cfg.encoder_only:
        dims = (B, shape.seq_len, V)
        outputs = math.prod(rules.named(LOGITS_AXES, dims, mesh).shard_shape(dims)) * act
    else:
        cache = tree_bytes(rules, M.cache_axes(cfg), specs.cache_specs(cfg, shape), mesh)
        if shape.kind == "decode":
            args["cache"] = cache
        dims = (B, 1, V)
        outputs = math.prod(rules.named(LOGITS_AXES, dims, mesh).shard_shape(dims)) * act \
            + cache
    return {"argument_bytes": sum(args.values()), "arguments": args,
            "output_bytes": outputs, "temp_bytes": None}


def fit_stages(cfg: ArchConfig, shape: InputShape, mesh, hbm: float) -> int:
    """The most whole stages (up to ``cfg.num_stages``) whose arguments fit
    in ``hbm`` bytes: argument bytes are affine in the stage count."""
    one, two = (memory(dataclasses.replace(cfg, num_stages=n), shape, mesh)["argument_bytes"]
                for n in (1, 2))
    per_stage, fixed = two - one, 2 * one - two
    if fixed > hbm:
        return 0
    return min(cfg.num_stages, int((hbm - fixed) // per_stage))


def _step_state(cfg: ArchConfig, shape: InputShape, model):
    """What ``shape``'s step takes beside the model and batch: AdamW's
    state for ``train``, an empty cache of ``shape``'s length for
    ``decode``, else None."""
    if shape.kind == "train":
        return adamw.init(model)
    if shape.kind == "decode":
        return M.init_decode_cache(cfg, shape.global_batch, shape.seq_len, device="meta")
    return None


def _run_step(cfg: ArchConfig, shape: InputShape, model, batch, state):
    """``shape``'s step at the reference's cost settings: the train step
    without remat (the loss, its gradients and AdamW; returns the loss),
    the prefill (``(last logits, cache)``; an encoder's encode, all
    logits) or one decode step against ``state``'s cache (``(logits,
    cache)``)."""
    if shape.kind == "train":
        return M.make_train_step(cfg, adamw.AdamWConfig(), remat=False)(model, state, batch)
    if shape.kind == "prefill":
        return M.encode_step(model, batch) if cfg.encoder_only else M.prefill_step(model, batch)
    return M.decode_step(model, state, batch)


def count_flops(cfg: ArchConfig, shape: InputShape) -> float:
    """FLOPs of ``shape``'s step (:func:`_run_step`) for ``cfg``, run on
    meta under ``FlopCounterMode``; a decode step reads its empty cache of
    ``shape``'s length whole."""
    model = M.BackboneLM(cfg, device="meta")
    state = _step_state(cfg, shape, model)
    counter = FlopCounterMode(display=False)
    with counter:
        _run_step(cfg, shape, model, specs.batch_specs(cfg, shape), state)
    return float(counter.get_total_flops())


# -- collectives: the step partitioned by DTensor on a fake process group ----

def _all_to_all(local, gather_dim, shard_dim, device_mesh, mesh_dim):
    """DTensor's all-to-all reshard as it runs on an accelerator's mesh:
    on a ``cpu`` mesh DTensor swaps it for an all-gather and a chunk
    (Gloo has no all-to-all), which would count a group's worth of bytes."""
    return torch.ops._dtensor.shard_dim_alltoall(
        local, gather_dim, shard_dim, device_mesh.get_group(mesh_dim).group_name)


@contextlib.contextmanager
def _private_torch():
    """The private torch pieces the count needs, all here; yields the
    fake backend's store.

    - ``torch.testing._internal.distributed.fake_pg``: importing it
      registers the ``fake`` process-group backend, whose collectives move
      nothing and return tensors of their result shapes.
    - ``placement_types.shard_dim_alltoall``, DTensor's all-to-all reshard,
      is :func:`_all_to_all` while the context lasts (see there).
    """
    from torch.testing._internal.distributed.fake_pg import FakeStore
    with contextlib.ExitStack() as stack:
        if hasattr(placement_types, "shard_dim_alltoall"):
            stack.enter_context(mock.patch.object(
                placement_types, "shard_dim_alltoall", _all_to_all))
        yield FakeStore()


@contextlib.contextmanager
def fake_mesh(mesh):
    """A ``DeviceMesh`` of ``mesh``'s shape and axis names on a fake
    process group of ``mesh.size`` ranks, this process rank 0; the group
    is destroyed on leaving, after an error too. An initialised process
    group is refused, not borrowed."""
    if dist.is_initialized():
        raise RuntimeError("a process group is initialised already; the "
                           "dry-run brings up a fake one of its own")
    with _private_torch() as store:
        dist.init_process_group("fake", store=store, rank=0, world_size=mesh.size)
        try:
            yield init_device_mesh("cpu", tuple(mesh.devices.shape),
                                   mesh_dim_names=mesh.axis_names)
        finally:
            dist.destroy_process_group()


def _ops(names: dict) -> dict:
    """``{"namespace.op": value}`` as ``{OpOverload: value}``, leaving out
    an op this torch does not define."""
    out = {}
    for name, value in names.items():
        space, op = name.split(".")
        packet = getattr(getattr(torch.ops, space), op, None)
        if packet is not None:
            out[packet.default] = value
    return out


COLLECTIVE_KINDS = _ops({
    "_c10d_functional.all_reduce": "all-reduce",
    "_c10d_functional.all_gather_into_tensor": "all-gather",
    "_c10d_functional.reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional.all_to_all_single": "all-to-all",
    "_dtensor.shard_dim_alltoall": "all-to-all",
})
# they carry a collective's result on: counted once, at the collective
CARRIERS = set(_ops({"_c10d_functional.wait_tensor": None,
                     "_c10d_functional._wrap_tensor_autograd": None}))


_FAILED = object()
STRIDED = getattr(placement_types, "_StridedShard", ())   # DTensor's private class
_aten = torch.ops.aten
# each contraction's operands (by position) and their contracting dims
CONTRACTIONS = {_aten.mm.default: ((0, 1), (1, 0)), _aten.bmm.default: ((0, 1), (2, 1)),
                _aten.addmm.default: ((1, 2), (1, 0)),
                _aten.baddbmm.default: ((1, 2), (2, 1))}
# the ops that make the residual stream: a residual add (its gradient's
# accumulation too), the embedding's gather, a VLM's prefix concatenation
STREAM_OPS = {_aten.add.Tensor, _aten.index.Tensor, _aten.embedding.default,
              _aten.cat.default}


def _contracted_alike(func, args) -> bool:
    """True where along every mesh axis the two operands of a contraction
    are both sharded on their contracting dims or neither is: XLA then
    contracts the shards in place (reducing a partial result); else it
    weighs moving an operand against reducing the result."""
    (i, j), (di, dj) = CONTRACTIONS[func]
    a, b = args[i], args[j]
    if not (isinstance(a, DTensor) and isinstance(b, DTensor)):
        return True
    return all((pa == Shard(di)) == (pb == Shard(dj))
               for pa, pb in zip(a.placements, b.placements))


def _logsumexp(x, dim, keepdim=False):
    """``logsumexp`` as the reductions XLA lowers it to: DTensor would
    gather its sharded axis (the vocabulary of the CE's logits) whole."""
    m = torch.amax(x, dim, keepdim=True)
    out = torch.log(torch.sum(torch.exp(x - m), dim, keepdim=True)) + m
    return out if keepdim else out.squeeze(dim)


def _nbytes(out) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(out)
               if isinstance(t, torch.Tensor))


class count_collectives(TorchDispatchMode):
    """Sums the result bytes of each collective the program issues on this
    rank, by the reference's kind names (``bytes``; :meth:`result` adds
    ``"total"``). ``wait_tensor`` and ``_wrap_tensor_autograd`` carry a
    collective's tensor on and are not counted; a collective of no known
    kind raises.

    Ops on DTensors pass to DTensor's own dispatch with this mode still
    active, so the collectives of its reshards reach the counter. DTensor
    places each op alone, by the cost of moving its operands; the mode
    adds what XLA's partitioner, placing the whole program, does:

    - a contraction's partial result is reduced at once (``_reduced``); one
      whose operands are sharded unlike along a mesh axis runs from the
      choice of operand layouts that moves the fewest bytes, result
      included (``_cheapest``);
    - an elementwise op's broadcast operand is replicated first
      (``_gathered_broadcasts``); a strided shard is replicated
      (``_unstrided``); results of a shape in ``pins`` made by
      ``STREAM_OPS`` take the pinned layout (the residual stream);
    - ``logsumexp`` runs as its reductions; a select along a sharded dim
      moves only its slice (``_selected``);
    - an op DTensor cannot run sharded (no sharding strategy, or one that
      fails on these operands) runs on operands replicated no further than
      it needs, else on local copies replicated whole; its name is counted
      in ``replicated_ops``;
    - a tensor the step allocates itself (not a DTensor) and then writes a
      DTensor into takes the layout of what is written, as a partitioner
      lays out a fresh buffer: the write moves nothing, and the tensor is
      that DTensor layout wherever it is read after (``layouts``).

    Every choice is remembered by the op and its operands' layouts, so a
    layer repeated is placed as its first instance was.
    """

    def __init__(self, pins: dict | None = None):
        super().__init__()
        self.pins = pins or {}
        self.bytes: dict[str, int] = {}
        self.replicated_ops: dict[str, int] = {}
        self.layouts: dict[int, tuple[torch.Tensor, object, tuple]] = {}
        self._choices: dict[str, int | None] = {}
        self._inside = False        # DTensor's own dispatch is running an op
        self._moving = False        # the counter is moving a DTensor itself

    def result(self) -> dict:
        out = dict(self.bytes)
        out["total"] = sum(self.bytes.values())
        return out

    def as_dtensor(self, t):
        """``t`` as a DTensor where it is a tensor with a recorded layout."""
        if isinstance(t, DTensor) or not isinstance(t, torch.Tensor):
            return t
        entry = self.layouts.get(id(t))
        if entry is None or entry[0] is not t:
            return t
        _, dm, placements = entry
        with self._own_moves():
            return meta_dtensor(t, dm, placements)

    @contextlib.contextmanager
    def _own_moves(self):
        """The counter's own reshards and wraps: the collectives they issue
        are counted (this mode pushed), and any op DTensor's autograd
        functions issue on the way passes to DTensor untouched."""
        moving, self._moving = self._moving, True
        try:
            with self:
                yield
        finally:
            self._moving = moving

    def _move(self, t, placements):
        """``t`` redistributed to ``placements`` (itself where it is)."""
        if tuple(t.placements) == tuple(placements):
            return t
        with self._own_moves():
            return t.redistribute(t.device_mesh, list(placements))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is _aten.detach_.default and isinstance(args[0], DTensor):
            # autograd's own mark on a DTensor that needs no gradient (some
            # torch versions give DTensor no sharding strategy for it)
            return args[0]
        if self._inside or self._moving:
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented
            return self._local(func, args, kwargs)
        args, kwargs = tree_map_only(torch.Tensor, self.as_dtensor, (args, kwargs))
        dts = [a for a in tree_leaves((args, kwargs)) if isinstance(a, DTensor)]
        if not dts:
            return self._local(func, args, kwargs)
        if func._schema.is_mutable and not isinstance(args[0], DTensor):
            return self._buffer_write(func, args, kwargs, dts)
        if func in CONTRACTIONS and not _contracted_alike(func, args):
            return self._cheapest(func, args, kwargs, dts)
        if func is _aten.logsumexp.default:
            with self:            # each reduction through the rules
                return _logsumexp(*args, **kwargs)
        if func is _aten.select.int and isinstance(args[0], DTensor):
            out = self._selected(*args)
            if out is not None:
                return out
        start = dict(self.bytes)
        out = self._sharded(func, args, kwargs)
        if out is not _FAILED:
            return out
        self.bytes = start
        name = str(func)
        self.replicated_ops[name] = self.replicated_ops.get(name, 0) + 1
        return self._cheapest(func, args, kwargs, dts, as_they_come=False)

    def _sharded(self, func, args, kwargs):
        """DTensor's run of the op, then the result's partial sums reduced
        (a contraction's) and its pinned layout; ``_FAILED`` where DTensor
        cannot run it sharded."""
        args, kwargs = self._gathered_broadcasts(func, args, kwargs)
        self._inside = True
        try:
            with self:
                out = func(*args, **kwargs)
        except Exception:
            return _FAILED
        finally:
            self._inside = False
        if func._schema.is_mutable:
            return out
        if func in CONTRACTIONS:
            out = self._reduced(out)
        out = self._unstrided(out)
        return self._pinned(out) if func in STREAM_OPS else out

    def _cheapest(self, func, args, kwargs, dts, *, as_they_come: bool = True):
        """The op run from each choice of its operands' layouts (as they
        come, or one replicated along one mesh axis or all), keeping the
        one that moves the fewest bytes with its result reduced and pinned:
        a contraction's, as XLA weighs gathering an operand against
        reducing a partial result (DTensor alone weighs only its operands'
        moves); an op DTensor cannot run as its operands come, replicated
        no further than it needs. Where no choice runs, the op runs on
        local copies of its operands replicated whole."""
        start = dict(self.bytes)
        best = None
        key = _signature(func, args, kwargs)
        choices = list(_layout_choices(args))[0 if as_they_come else 1:]
        if key in self._choices:       # the same op on the same layouts: its pick
            i = self._choices[key]
            choices = choices[i:i + 1] if i is not None else []
        for i, choice in enumerate(choices):
            self.bytes = dict(start)
            try:
                tried = tuple(a if c is None else self._move(a, c)
                              for a, c in zip(args, choice))
            except Exception:     # DTensor cannot reshard an uneven shard so
                continue
            out = self._sharded(func, tried, kwargs)
            if out is _FAILED:
                continue
            moved = sum(self.bytes.values()) - sum(start.values())
            if best is None or moved < best[0]:
                best = (moved, out, self.bytes, i)
        if best is None:
            self._choices.setdefault(key, None)
            self.bytes = start
            return self._replicated(func, args, kwargs, dts)
        self._choices.setdefault(key, best[3])
        self.bytes = best[2]
        return best[1]

    def _replicated(self, func, args, kwargs, dts):
        """The op on local copies of its DTensor operands replicated whole."""
        dm = dts[0].device_mesh
        rep = [Replicate()] * dm.ndim
        with self._own_moves():
            local = tree_map_only(DTensor, lambda a: a.redistribute(dm, rep).to_local(),
                                  (args, kwargs))
            out = func(*local[0], **local[1])
            if func._schema.is_mutable:
                return args[0]
            return tree_map_only(torch.Tensor, lambda o: DTensor.from_local(
                o, dm, rep, run_check=False), out)

    def _selected(self, t, dim, index):
        """``t[..., index, ...]`` along a dim sharded over some mesh axes:
        the slice goes from the shard that holds it to the others along
        those axes (its bytes counted as an all-gather's result), the rest
        of the layout kept. DTensor would gather the whole tensor first (a
        chunked recurrence's loop over its chunk axis, sharded, gathers it
        once a chunk). None where the dim is not sharded."""
        dim %= t.ndim
        axes = [i for i, p in enumerate(t.placements) if p == Shard(dim)]
        if not axes:
            return None
        placements = [Replicate() if i in axes
                      else Shard(p.dim - (p.dim > dim)) if isinstance(p, Shard) else p
                      for i, p in enumerate(t.placements)]
        shape = t.shape[:dim] + t.shape[dim + 1:]
        with self._own_moves():
            out = meta_dtensor(torch.empty(shape, dtype=t.dtype, device="meta"),
                               t.device_mesh, placements)
        self.bytes["all-gather"] = self.bytes.get("all-gather", 0) \
            + out.to_local().numel() * out.element_size()
        return out

    def _gathered_broadcasts(self, func, args, kwargs):
        """An elementwise op's broadcast operand (of lower rank than another,
        a norm's scale or a bias) replicated first, as XLA broadcasts it:
        DTensor would slice the larger operand to the small one's sharding
        instead, which moves nothing now and reshards the result later."""
        if torch.Tag.pointwise not in func.tags:
            return args, kwargs
        top = max(d.ndim for d in tree_leaves((args, kwargs)) if isinstance(d, DTensor))

        def gather(a):
            if a.ndim == top:
                return a
            return self._move(a, [Replicate()] * a.device_mesh.ndim)
        return tree_map_only(DTensor, gather, (args, kwargs))

    def _reduced(self, out):
        """A contraction's partial sums reduced into its result at once, as
        XLA partitions a dot over a sharded contracting dimension; DTensor
        would carry them on through later linear ops (a reshape, RoPE, the
        attention scores) and reduce a larger tensor there."""
        def reduce(t):
            return self._move(t, [Replicate() if p.is_partial() else p
                                  for p in t.placements])
        return tree_map_only(DTensor, reduce, out)

    def _unstrided(self, out):
        """A result sharded along a mesh axis in DTensor's strided form (a
        view that splits a sharded dim across two, as GQA's heads into KV
        heads and groups) replicated along that axis: DTensor plans every
        later reshard of such a tensor by a search whose states grow with
        the mesh's axes, minutes an op on the 2 x 16 x 16 mesh."""
        def plain(t):
            return self._move(t, [Replicate() if isinstance(p, STRIDED) else p
                                  for p in t.placements])
        return tree_map_only(DTensor, plain, out)

    def _pinned(self, out):
        """``out`` with every DTensor of a pinned shape in its pinned layout."""
        def pin(t):
            placements = self.pins.get(tuple(t.shape))
            return t if placements is None else self._move(t, placements)
        return tree_map_only(DTensor, pin, out)

    def _local(self, func, args, kwargs):
        if func is torch.ops.aten.equal.default and all(
                a.device.type == "meta" for a in args[:2]):
            # DTensor's masked gather checks that two uses of a mask hold the
            # same data; meta tensors hold none
            return True
        kind = COLLECTIVE_KINDS.get(func)
        if kind is None and func.namespace in ("_c10d_functional", "_dtensor") \
                and func not in CARRIERS:
            raise NotImplementedError(f"{func}: a collective the counter has no kind for")
        out = func(*args, **kwargs)
        if kind is not None:
            self.bytes[kind] = self.bytes.get(kind, 0) + _nbytes(out)
        return out

    def _buffer_write(self, func, args, kwargs, dts):
        """A DTensor written into a tensor the step allocated: the write
        on global-shaped stand-ins, nothing moved, the buffer's layout
        recorded when it has the written value's rank."""
        dst = args[0]
        base = dst if dst._base is None else dst._base
        value = dts[-1]
        if base.ndim == value.ndim and id(base) not in self.layouts:
            self.layouts[id(base)] = (base, value.device_mesh, tuple(value.placements))
        whole = tree_map_only(DTensor, lambda a: torch.empty(
            a.shape, dtype=a.dtype, device=dst.device), (args, kwargs))
        return self._local(func, *whole)


def _layout_choices(args):
    """Per positional operand: None (as it comes) or the placements it is
    redistributed to first: replicated along one of its sharded or partial
    mesh axes, or along all of them (only the last beside more than two
    DTensor operands); every combination, the first all None."""
    per_arg = []
    few = sum(isinstance(a, DTensor) for a in args) <= 2
    for a in args:
        options = [None]
        if isinstance(a, DTensor) and not few:
            options.append([Replicate()] * a.device_mesh.ndim)
        elif isinstance(a, DTensor):
            moved = [i for i, p in enumerate(a.placements) if not isinstance(p, Replicate)]
            for axes in [[i] for i in moved] + ([moved] if len(moved) > 1 else []):
                options.append([Replicate() if i in axes else p
                                for i, p in enumerate(a.placements)])
        per_arg.append(options)
    return itertools.product(*per_arg)


def _signature(func, args, kwargs) -> str:
    """The op and its operands' shapes, dtypes and layouts, as a key."""
    def sig(t):
        if isinstance(t, DTensor):
            return f"D{tuple(t.shape)}{t.dtype}{tuple(t.placements)}{t.stride()}"
        return f"T{tuple(t.shape)}{t.dtype}"
    return f"{func}{tree_map_only(torch.Tensor, sig, (args, kwargs))}"


def placements_of(spec, mesh) -> list:
    """DTensor placements of a resolved spec: ``Shard(dim)`` on each mesh
    axis the spec names for ``dim`` (in mesh order, as a spec entry of
    several axes orders them), ``Replicate()`` on the others."""
    out = [Replicate()] * len(mesh.axis_names)
    for dim, entry in enumerate(spec):
        for axis in sharding.spec_axes(entry):
            out[mesh.axis_names.index(axis)] = Shard(dim)
    return out


def meta_dtensor(t: torch.Tensor, dm, placements) -> DTensor:
    """A meta DTensor of ``t``'s shape and dtype laid out by ``placements``
    (rank 0's local shard, nothing allocated or moved)."""
    local = list(t.shape)
    for mesh_dim, p in enumerate(placements):
        if isinstance(p, Shard):
            local[p.dim] //= dm.size(mesh_dim)
    return DTensor.from_local(torch.empty(local, dtype=t.dtype, device="meta"), dm,
                              list(placements), run_check=False, shape=t.shape,
                              stride=t.stride())


def _param_specs(cfg: ArchConfig, model, rules, mesh) -> dict:
    """The resolved spec of each of ``model.named_parameters()``: each leaf
    of the reference's tree resolved on its shape there; a stage's tensor
    takes its leaf's spec, resolved on the stacked shape (a leading
    ``num_stages`` axis, ``"stack"``), without that leading entry, since
    the port keeps one tensor per stage where the reference stacks them
    (``models.model.stacked_tree``)."""
    named = dict(model.named_parameters())
    names = M.stacked_tree(cfg, {n: n for n in named}, tuple)
    stacked = M.stacked_tree(cfg, named, specs._stack)
    axes = M.param_axes(cfg)
    out = {}

    def put(spec, name_leaf, t):
        if isinstance(name_leaf, tuple):       # one name a stage
            resolved = sharding.P(*rules.resolve(spec, t.shape, mesh)[1:])
            out.update(dict.fromkeys(name_leaf, resolved))
        else:
            out[name_leaf] = rules.resolve(spec, t.shape, mesh)
    sharding.map_specs(put, axes, names, stacked)
    return out


def _cache_specs(cfg: ArchConfig, shape: InputShape, rules, mesh) -> list[dict]:
    """The resolved specs of each layer's cache, in execution order."""
    axes, stacked = M.cache_axes(cfg), specs.cache_specs(cfg, shape)
    resolved = sharding.map_specs(lambda spec, t: rules.resolve(spec, t.shape, mesh),
                                  axes, stacked)
    per_layer = [{k: sharding.P(*v[1:]) for k, v in resolved["stages"][i].items()}
                 for i in range(len(cfg.stage_pattern))] * cfg.num_stages
    return per_layer + list(resolved.get("tail", ()))


def _laid_out(x, *, spec, mesh):
    """``x`` (a DTensor) redistributed to ``spec`` on ``mesh``."""
    return x.redistribute(x.device_mesh, placements_of(spec, mesh))


# The residual stream (B, S, d_model), and its gradient, in the batch's
# layout. DTensor picks each op's layout alone, by the cost of moving its
# inputs: a residual add of a partial sum reduce-scatters it and shards the
# stream along d_model, and every later projection then contracts a
# sharded d into partial sums of its whole output. XLA's partitioner,
# placing the whole program at once, keeps the stream in the batch's
# layout and all-reduces each projection's partial output into it (the
# reference's HLO); the counter pins the stream there.
RESIDUAL_AXES = sharding.P("batch", "seq", None)


def count_collective_bytes(cfg: ArchConfig, shape: InputShape, mesh,
                           rules: sharding.ShardingRules = sharding.DEFAULT_RULES
                           ) -> tuple[dict, dict]:
    """(collective bytes by kind with ``"total"``, replicated ops by name)
    of ``shape``'s step for ``cfg`` on ``mesh``, this device being rank 0.

    The step is :func:`_run_step`, as :func:`count_flops` runs it, on meta
    DTensors of a :func:`fake_mesh`: the parameters (and AdamW's master / m
    / v) laid out by ``rules`` over the reference's parameter tree
    (:func:`_param_specs`), the batch by ``BATCH_AXES``, a decode's cache
    by ``cache_axes``; tensors the step makes itself are replicated
    (DTensor's implicit replication). Attention takes its queries as one
    block, as the reference's cost programs do (one chunk): the plain
    version's 256-query blocks would cost DTensor's propagation a plan for
    every block's shapes. The outputs are then laid out as the
    reference's ``jax.jit`` names them in ``out_shardings``: a training
    step's loss replicated and its parameters and state in their own
    layouts; a prefill's last logits by ``("batch", "seq", "vocab")`` and
    its cache by ``cache_axes``; a decode's the same; an encoder's logits
    whole."""
    model = M.BackboneLM(cfg, device="meta")
    S = 1 if shape.kind == "decode" else shape.seq_len
    for module in model.modules():
        if isinstance(module, Attention):
            module.query_block = S
    p_specs = _param_specs(cfg, model, rules, mesh)
    batch = specs.batch_specs(cfg, shape)
    b_axes = sharding.BATCH_AXES[cfg.input_mode]
    residual = (shape.global_batch, S, cfg.d_model)
    with fake_mesh(mesh) as dm:
        counter = count_collectives(pins={residual: tuple(placements_of(
            rules.resolve(RESIDUAL_AXES, residual, mesh), mesh))})

        def lay(t, spec):
            return meta_dtensor(t, dm, placements_of(spec, mesh))

        def to(x, spec):
            x = counter.as_dtensor(x)
            if not isinstance(x, DTensor):
                x = DTensor.from_local(x, dm, [Replicate()] * dm.ndim, run_check=False)
            return x.redistribute(dm, placements_of(spec, mesh))

        for name, p in list(model.named_parameters()):
            owner, _, leaf = name.rpartition(".")
            module = model.get_submodule(owner) if owner else model
            module._parameters[leaf] = param = torch.nn.Parameter(
                lay(p, p_specs[name]), requires_grad=shape.kind == "train")
            if param.requires_grad:
                # the gradient takes its parameter's layout, where the
                # elementwise update reads it
                param.register_hook(functools.partial(_laid_out, spec=p_specs[name],
                                                      mesh=mesh))
                param.requires_grad_(False)
        batch = {k: lay(t, rules.resolve(b_axes[k], t.shape, mesh))
                 for k, t in batch.items()}
        named = dict(model.named_parameters())
        state = None
        if shape.kind == "train":
            state = {k: {n: lay(torch.empty(p.shape, dtype=torch.float32, device="meta"),
                                p_specs[n]) for n, p in named.items()}
                     for k in ("master", "m", "v")}
            state["count"] = lay(torch.empty((), dtype=torch.int32, device="meta"),
                                 sharding.P())
        elif shape.kind != "prefill":
            c_specs = _cache_specs(cfg, shape, rules, mesh)
            state = _step_state(cfg, shape, model)
            state["layers"] = [{k: lay(t, s[k]) for k, t in c.items()}
                               for c, s in zip(state["layers"], c_specs)]
        with counter, implicit_replication():
            out = _run_step(cfg, shape, model, batch, state)
            if shape.kind == "train":
                to(out, sharding.P())
                for n, p in model.named_parameters():
                    to(p, p_specs[n])
                    for k in ("master", "m", "v"):
                        to(state[k][n], p_specs[n])
            elif shape.kind == "prefill" and cfg.encoder_only:
                to(out, rules.resolve(LOGITS_AXES, out.shape, mesh))
            else:
                logits, cache = out
                to(logits, rules.resolve(LOGITS_AXES, logits.shape, mesh))
                for c, s in zip(cache["layers"], _cache_specs(cfg, shape, rules, mesh)):
                    for k, t in c.items():
                        to(t, s[k])
    return counter.result(), dict(sorted(counter.replicated_ops.items()))


def cost(cfg: ArchConfig, shape: InputShape, mesh, num_stages: int) -> dict:
    """The cost-mode record of ``cfg`` at ``num_stages`` stages: the FLOPs
    of the plain meta run over the mesh's devices; on a mesh of more than
    one device the collectives of the DTensor run and its replicated ops."""
    cfg = dataclasses.replace(cfg, num_stages=num_stages)
    record = {"flops": count_flops(cfg, shape) / mesh.size, "bytes": None,
              "collectives": {"total": 0}}
    if mesh.size > 1:
        record["collectives"], record["replicated_ops"] = \
            count_collective_bytes(cfg, shape, mesh)
    return record


def run_combo(arch: str, shape_name: str, *, mesh_name: str = "pod1",
              memory_only: bool = False) -> dict:
    cfg = configs.get(arch)
    shape = INPUT_SHAPES[shape_name]
    # the collective count follows DTensor's rules, which change between
    # torch versions: records of two versions are not compared
    record: dict = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                    "kind": shape.kind, "torch": torch.__version__}
    ok, reason = shape_applicable(cfg, shape)
    if not ok:
        record["skipped"] = reason
        return record
    mesh = make_named_mesh(mesh_name)
    record["mesh_shape"] = mesh.shape
    record["devices"] = mesh.size
    t0 = time.time()
    mem = memory(cfg, shape, mesh)
    mem["hbm_bytes"] = mesh_lib.HBM_BYTES
    mem["fits"] = mem["argument_bytes"] <= mesh_lib.HBM_BYTES
    if mesh_name == "card":
        # the depth cut that fits keeps the embedding, head and tail
        n = mem["fit_stages"] = fit_stages(cfg, shape, mesh, mesh_lib.HBM_BYTES)
        mem["fit_layers"] = n * len(cfg.stage_pattern) + len(cfg.tail_pattern) if n else 0
    record["memory"] = mem
    record["memory_wall_s"] = round(time.time() - t0, 2)
    if not memory_only:
        for n in COST_STAGES:
            record[f"cost_{n}stage"] = cost(cfg, shape, mesh, n)
    record["wall_s"] = round(time.time() - t0, 2)
    return record


def all_combos():
    for arch in configs.ARCH_IDS:
        for shape_name in INPUT_SHAPES:
            yield arch, shape_name


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--card", action="store_true",
                    help="the one-card (1, 1) mesh of an H100")
    ap.add_argument("--memory-only", action="store_true")
    ap.add_argument("--out", default=str(OUT_DIR))
    args = ap.parse_args(argv)
    if args.card and args.multi_pod:
        ap.error("--card and --multi-pod are two meshes")
    if not args.all and not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all")
    mesh_name = "card" if args.card else "pod2" if args.multi_pod else "pod1"

    out_dir = pathlib.Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    combos = list(all_combos()) if args.all else [(args.arch, args.shape)]
    failures = []
    for arch, shape_name in combos:
        tag = f"{arch}_{shape_name}_{mesh_name}"
        try:
            rec = run_combo(arch, shape_name, mesh_name=mesh_name,
                            memory_only=args.memory_only)
        except Exception as e:  # a failure here is a bug in the port
            rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                   "error": f"{type(e).__name__}: {e}",
                   "traceback": traceback.format_exc()[-2000:]}
            failures.append(tag)
        (out_dir / f"{tag}.json").write_text(json.dumps(rec, indent=1))
        status = rec.get("skipped") and "SKIP" or rec.get("error") and "FAIL" or "OK"
        extra = rec.get("skipped") or rec.get("error") or f"{rec.get('wall_s')}s"
        print(f"[{status:4s}] {tag}: {extra}", flush=True)

    if failures:
        raise SystemExit(f"{len(failures)} dry-run failures: {failures}")


if __name__ == "__main__":
    main()
