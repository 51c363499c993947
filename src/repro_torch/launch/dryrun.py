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
                exist here (null); collective bytes are null on a mesh of
                more than one device, where the port has no partitioner
                (a multi-card layer is ROADMAP item 18), and 0 on the card.

On ``meta`` the port's kernels take their plain versions, which compute
nothing there (``kernels.ops.on_card``): no kernel is launched.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-9b --shape train_4k [--card]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod | --card] [--memory-only]
Outputs JSON under experiments/dryrun_torch/.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import pathlib
import time
import traceback

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import configs
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import sharding, specs
from repro_torch.models import layers
from repro_torch.models import model as M
from repro_torch.models.config import INPUT_SHAPES, ArchConfig, InputShape, shape_applicable
from repro_torch.optim import adamw

OUT_DIR = pathlib.Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"
COST_STAGES = (2, 4)


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
    logits_axes = sharding.P("batch", "seq", "vocab")
    if shape.kind == "train":
        o = specs.opt_specs(cfg)
        opt = sum(tree_bytes(rules, p_axes, o[k], mesh) for k in ("master", "m", "v"))
        args["opt"] = opt + o["count"].element_size()
        outputs = 4 + params + args["opt"]                 # float32 loss
    elif shape.kind == "prefill" and cfg.encoder_only:
        dims = (B, shape.seq_len, V)
        outputs = math.prod(rules.named(logits_axes, dims, mesh).shard_shape(dims)) * act
    else:
        cache = tree_bytes(rules, M.cache_axes(cfg), specs.cache_specs(cfg, shape), mesh)
        if shape.kind == "decode":
            args["cache"] = cache
        dims = (B, 1, V)
        outputs = math.prod(rules.named(logits_axes, dims, mesh).shard_shape(dims)) * act \
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


def count_flops(cfg: ArchConfig, shape: InputShape) -> float:
    """FLOPs of ``shape``'s step for ``cfg``, run on meta under
    ``FlopCounterMode``: the train step without remat (the loss, its
    gradients and AdamW), the prefill (an encoder's encode) or one decode
    step against an empty cache of ``shape``'s length, which reads it whole."""
    model = M.BackboneLM(cfg, device="meta")
    batch = specs.batch_specs(cfg, shape)
    counter = FlopCounterMode(display=False)
    if shape.kind == "train":
        state = adamw.init(model)
        step = M.make_train_step(cfg, adamw.AdamWConfig(), remat=False)
        with counter:
            step(model, state, batch)
    elif shape.kind == "prefill":
        with counter:
            if cfg.encoder_only:
                M.encode_step(model, batch)
            else:
                M.prefill_step(model, batch)
    else:
        cache = M.init_decode_cache(cfg, shape.global_batch, shape.seq_len, device="meta")
        with counter:
            M.decode_step(model, cache, batch)
    return float(counter.get_total_flops())


def cost(cfg: ArchConfig, shape: InputShape, mesh, num_stages: int) -> dict:
    """The cost-mode record of ``cfg`` at ``num_stages`` stages."""
    flops = count_flops(dataclasses.replace(cfg, num_stages=num_stages), shape)
    return {"flops": flops / mesh.size, "bytes": None,
            "collectives": {"total": 0} if mesh.size == 1 else None}


def run_combo(arch: str, shape_name: str, *, mesh_name: str = "pod1",
              memory_only: bool = False) -> dict:
    cfg = configs.get(arch)
    shape = INPUT_SHAPES[shape_name]
    record: dict = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                    "kind": shape.kind}
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
