"""Roofline analysis from the dry-run records, for the H100.

The counterpart of the reference's ``launch/roofline.py`` (TPU v5e). The
dry-run (``launch/dryrun.py``) counts the FLOPs of 2-stage and 4-stage
programs; this module extrapolates linearly to the config's depth:

    per_stage = (cost(4) - cost(2)) / 2
    total     = cost(2) + (num_stages - 2) * per_stage

and sets three per-chip terms beside each other:

    compute_s    = flops_per_chip / PEAK_FLOPS_BF16
    memory_s     = est_bytes_per_chip / HBM_BANDWIDTH
    collective_s = 0 on one card; n/a (null) on a mesh of more

The chip count is the record's mesh (``devices``; a record without one is a
card's), not a fixed pod. On a mesh the records carry collective bytes
(the dry-run's count of DTensor's collectives on rank 0, which depends on
the torch version the record names: a table takes records of one),
extrapolated the same way into ``coll_bytes`` and ``coll_by_kind``; ``collective_s`` stays
null there, since the port has no interconnect figure for a 256- or
512-card mesh (``NVLINK_BANDWIDTH`` is one host's). ``memory_s`` comes from
the analytic HBM model (:func:`analytic_hbm_bytes`, the reference's napkin model at the record's
shard counts); the HLO-bytes term of the reference has no counterpart here
(no compiler; "n/a"). ``dominant`` is taken over the terms that exist.
MODEL_FLOPS = 6 N D (train) / 2 N_active D (inference) per chip-step, and
MODEL_FLOPS / counted FLOPs is the ``useful`` share (the plain attention
counts every (query, key) pair, masked ones included, as the reference's
one-chunk cost programs do).

  PYTHONPATH=src python -m repro_torch.launch.roofline [--dir DIR] [--mesh card|pod1|pod2]
"""
from __future__ import annotations

import argparse
import csv
import dataclasses
import json
import pathlib

from repro_torch import configs
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models.config import INPUT_SHAPES

DRYRUN_DIR = pathlib.Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    chips: int
    flops: float                 # per chip, extrapolated to full depth
    bytes_: float | None         # HLO bytes: none without a compiler
    est_bytes: float             # analytic HBM traffic estimate, per chip
    coll_bytes: float | None     # collective bytes per chip, extrapolated
    coll_by_kind: dict | None
    compute_s: float
    memory_s: float | None       # from HLO bytes: none
    est_memory_s: float          # from the analytic model (verdict basis)
    collective_s: float | None
    dominant: str
    model_flops: float           # useful flops per chip
    useful_ratio: float
    note: str = ""

    def step_time_bound_s(self) -> float:
        return max(t for t in (self.compute_s, self.est_memory_s, self.collective_s)
                   if t is not None)


def analytic_hbm_bytes(arch: str, shape_name: str, *, model_shards: int = 16,
                       data_shards: int = 16) -> float:
    """:func:`hbm_bytes` of a registered config and input shape."""
    return hbm_bytes(configs.get(arch), INPUT_SHAPES[shape_name],
                     model_shards=model_shards, data_shards=data_shards)


def hbm_bytes(cfg, shape, *, model_shards: int, data_shards: int) -> float:
    """Per-chip HBM traffic estimate (the reference's napkin model):

      weights:   each pass reads the model-sharded bf16 weights once
                 (P / model_shards a chip); training re-reads them for the
                 backward and the recomputed forward, and the optimizer
                 touches the float32 master / m / v shard (P / chips x 24 B).
      acts:      tokens a chip x d_model x 2 B a layer, with pass factors
                 {train: 6, prefill / decode: 3}.
      KV cache:  decode reads a chip's cache slice once a token; prefill
                 writes it once.
    """
    chips = model_shards * data_shards
    P = cfg.param_count() * 2                      # bf16
    L = cfg.num_layers

    if shape.kind == "train":
        weights = 5 * P / model_shards + 24 * cfg.param_count() / chips * 4 / 4
        tokens_local = shape.global_batch * shape.seq_len / data_shards
        acts = tokens_local * cfg.d_model * 2 * L * 6
        return weights + acts
    if shape.kind == "prefill":
        weights = P / model_shards
        tokens_local = shape.global_batch * shape.seq_len / data_shards
        acts = tokens_local * cfg.d_model * 2 * L * 3
        cache_w = _cache_bytes(cfg, shape) / chips
        return weights + acts + cache_w
    weights = P / model_shards
    cache_r = _cache_bytes(cfg, shape) / chips
    toks = max(shape.global_batch / data_shards, 1) * cfg.d_model * 2 * L * 3
    return weights + cache_r + toks


def _cache_bytes(cfg, shape) -> float:
    total = 0.0
    for spec in (cfg.stage_pattern * cfg.num_stages) + cfg.tail_pattern:
        if spec.attn in ("full", "swa"):
            length = min(cfg.window, shape.seq_len) if spec.attn == "swa" \
                else shape.seq_len
            total += shape.global_batch * length * cfg.kv_dim * 2 * 2
        elif spec.attn == "mamba":
            total += shape.global_batch * cfg.d_inner * (
                cfg.mamba_d_state * 4 + (cfg.mamba_conv - 1) * 2)
        elif spec.attn == "rwkv":
            total += shape.global_batch * cfg.rwkv_heads * \
                cfg.rwkv_head_dim ** 2 * 4
    return total


def at_depth(c2: float, c4: float, num_stages: int) -> float:
    """The 2- and 4-stage costs extrapolated to ``num_stages`` stages."""
    delta = max((c4 - c2) / 2.0, 0.0)
    return c2 + (num_stages - 2) * delta


def _extrapolate(rec: dict, field: str, num_stages: int) -> float | None:
    """``field`` ("flops", "bytes" or "coll") at ``num_stages`` stages; None
    where the records carry none."""
    c2, c4 = rec["cost_2stage"], rec["cost_4stage"]
    if field == "coll":
        if c2["collectives"] is None or c4["collectives"] is None:
            return None
        return at_depth(c2["collectives"]["total"], c4["collectives"]["total"], num_stages)
    if c2[field] is None or c4[field] is None:
        return None
    return at_depth(c2[field], c4[field], num_stages)


def _coll_by_kind(rec: dict, num_stages: int) -> dict | None:
    c2, c4 = rec["cost_2stage"]["collectives"], rec["cost_4stage"]["collectives"]
    if c2 is None or c4 is None:
        return None
    return {k: at_depth(c2.get(k, 0), c4.get(k, 0), num_stages)
            for k in set(c2) | set(c4) if k != "total"}


def _model_flops(arch: str, shape_name: str, chips: int) -> float:
    return model_flops(configs.get(arch), INPUT_SHAPES[shape_name], chips)


def model_flops(cfg, shape, chips: int) -> float:
    """6 N D (train) / 2 N_active D (inference) over ``chips``."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        total = 6.0 * n_active * shape.global_batch * shape.seq_len
    elif shape.kind == "prefill":
        total = 2.0 * n_active * shape.global_batch * shape.seq_len
    else:  # decode: one token per sequence
        total = 2.0 * n_active * shape.global_batch
    return total / chips


def analyze(rec: dict) -> Roofline | None:
    if "skipped" in rec or "error" in rec or "cost_2stage" not in rec:
        return None
    n = configs.get(rec["arch"]).num_stages
    chips = rec.get("devices", 1)
    model_shards = rec.get("mesh_shape", {}).get("model", 1)
    flops = _extrapolate(rec, "flops", n)
    bytes_ = _extrapolate(rec, "bytes", n)
    coll = _extrapolate(rec, "coll", n)
    est_bytes = analytic_hbm_bytes(rec["arch"], rec["shape"], model_shards=model_shards,
                                   data_shards=chips // model_shards)
    compute_s = flops / mesh_lib.PEAK_FLOPS_BF16
    memory_s = None if bytes_ is None else bytes_ / mesh_lib.HBM_BANDWIDTH
    est_memory_s = est_bytes / mesh_lib.HBM_BANDWIDTH
    # one card moves nothing between chips; the port has no interconnect
    # figure for a mesh of 256 or 512 cards
    collective_s = 0.0 if coll == 0 else None
    terms = {"compute": compute_s, "memory": est_memory_s, "collective": collective_s}
    dominant = max((k for k, v in terms.items() if v is not None), key=terms.get)
    model_flops = _model_flops(rec["arch"], rec["shape"], chips)
    return Roofline(
        arch=rec["arch"], shape=rec["shape"], chips=chips, flops=flops, bytes_=bytes_,
        est_bytes=est_bytes, coll_bytes=coll, coll_by_kind=_coll_by_kind(rec, n),
        compute_s=compute_s, memory_s=memory_s, est_memory_s=est_memory_s,
        collective_s=collective_s, dominant=dominant, model_flops=model_flops,
        useful_ratio=model_flops / flops if flops else 0.0,
        note=_suggestion(dominant, rec))


def _suggestion(dominant: str, rec: dict) -> str:
    if dominant == "collective":
        return "overlap or reshard: less all-gather volume, or a reduce-scatter"
    if dominant == "memory":
        if rec["kind"] == "decode":
            return ("decode is KV / weight-bandwidth bound: quantize the cache or "
                    "widen the batch to amortize weight reads")
        return "increase arithmetic intensity: larger tiles, fusion"
    return "compute-bound: the tensor cores' roofline; only algorithmic wins left"


def load_all(mesh: str = "card", directory=DRYRUN_DIR) -> list[Roofline]:
    """The rows of ``mesh``'s records in ``directory``. Records of two
    torch versions are refused: DTensor's rules, and with them the
    collective bytes, change between versions."""
    out, versions = [], set()
    for p in sorted(pathlib.Path(directory).glob(f"*_{mesh}.json")):
        rec = json.loads(p.read_text())
        r = analyze(rec)
        if r:
            versions.add(rec.get("torch"))
            out.append(r)
    if len(versions) > 1:
        raise ValueError(f"{directory}: {mesh} records of torch "
                         f"{sorted(map(str, versions))}; dry-run them with one")
    return out


def _ms(t: float | None, fmt: str) -> str:
    return "n/a" if t is None else f"{t * 1e3:{fmt}}ms"


def _num(x: float | None) -> str:
    return "n/a" if x is None else f"{x:.3g}"


def _kinds(by_kind: dict | None) -> str:
    if not by_kind:
        return "n/a" if by_kind is None else "-"
    return ", ".join(f"{k} {v:.3g}" for k, v in sorted(by_kind.items()))


def markdown_table(rows: list[Roofline]) -> str:
    hdr = ("| arch | shape | chips | flops/chip | HLO bytes | est bytes | coll B | "
           "coll B by kind | compute | mem(HLO) | mem(est) | coll | bound | useful |\n"
           "|---|---|---|---|---|---|---|---|---|---|---|---|---|---|\n")
    fmt = []
    for r in rows:
        fmt.append(
            f"| {r.arch} | {r.shape} | {r.chips} | {r.flops:.3g} | {_num(r.bytes_)} | "
            f"{r.est_bytes:.3g} | {_num(r.coll_bytes)} | {_kinds(r.coll_by_kind)} | "
            f"{_ms(r.compute_s, '.1f')} | {_ms(r.memory_s, '.0f')} | "
            f"{_ms(r.est_memory_s, '.1f')} | {_ms(r.collective_s, '.1f')} | "
            f"**{r.dominant}** | {r.useful_ratio:.2f} |")
    return hdr + "\n".join(fmt) + "\n"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=str(DRYRUN_DIR))
    ap.add_argument("--mesh", default="card", choices=("card", "pod1", "pod2"))
    args = ap.parse_args(argv)
    directory = pathlib.Path(args.dir)
    rows = load_all(args.mesh, directory)
    table = markdown_table(rows)
    print(table)
    (directory / f"roofline_{args.mesh}.md").write_text(table)
    with (directory / f"roofline_{args.mesh}.csv").open("w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=[
            "arch", "shape", "chips", "flops", "bytes", "est_bytes", "coll_bytes",
            "compute_s", "memory_s", "est_memory_s", "collective_s",
            "dominant", "model_flops", "useful_ratio", "note"])
        w.writeheader()
        for r in rows:
            w.writerow({"arch": r.arch, "shape": r.shape, "chips": r.chips,
                        "flops": r.flops, "bytes": r.bytes_, "est_bytes": r.est_bytes,
                        "coll_bytes": r.coll_bytes, "compute_s": r.compute_s,
                        "memory_s": r.memory_s, "est_memory_s": r.est_memory_s,
                        "collective_s": r.collective_s, "dominant": r.dominant,
                        "model_flops": r.model_flops, "useful_ratio": r.useful_ratio,
                        "note": r.note})
    print(f"wrote {directory}/roofline_{args.mesh}.md and .csv ({len(rows)} rows)")


if __name__ == "__main__":
    main()
