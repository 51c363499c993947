"""Carry statistics, datasets, engine ledgers, serving pools, meshes,
sharded backends, feature maps and model parameters across from numpy
arrays, and a model's parameters, gradients and optimizer state both ways
(``model_tree_of``, ``named_tensors_from``, ``opt_state_from``).

Everything here goes through ``np.asarray``, so any object whose arrays
convert to numpy (the reference package's arrays included) can be handed
over without this package importing the framework that made it. bfloat16
arrays (numpy's bfloat16 extension type) are carried bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Hashable, Mapping, Sequence

import numpy as np
import torch

from repro_torch.core import features
from repro_torch.core.sufficient_stats import SuffStats
from repro_torch.data.synthetic import FederatedDataset
from repro_torch.models.config import ArchConfig
from repro_torch.models.model import BackboneLM, stacked_tree
from repro_torch.launch.mesh import Mesh, make_mesh
from repro_torch.server.distributed import ShardedBackend
from repro_torch.server.engine import CoalescerPolicy, FusionEngine
from repro_torch.server.pool import EnginePool


def tensor_from_numpy(x, *, dtype=None, device="cuda") -> torch.Tensor:
    """``np.asarray(x)`` as a tensor on ``device`` (bf16 kept bit-exact)."""
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16).copy())
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(arr).copy())
    return t.to(device=device, dtype=dtype or t.dtype)


def stats_from_numpy(gram, moment, count, yty=None, *, dtype=None,
                     device="cuda") -> SuffStats:
    """SuffStats from numpy-convertible (G, h, n[, yty])."""
    G = tensor_from_numpy(gram, dtype=dtype, device=device)
    return SuffStats(
        gram=G,
        moment=tensor_from_numpy(moment, dtype=G.dtype, device=device),
        count=torch.tensor(int(np.asarray(count)), dtype=torch.int32,
                           device=device),
        yty=None if yty is None
        else tensor_from_numpy(yty, dtype=G.dtype, device=device))


def suffstats_from(obj, *, dtype=None, device="cuda") -> SuffStats:
    """SuffStats from any object with ``.gram/.moment/.count/.yty`` arrays."""
    return stats_from_numpy(obj.gram, obj.moment, obj.count,
                            getattr(obj, "yty", None), dtype=dtype,
                            device=device)


def dataset_from_numpy(clients: Sequence[tuple], test_A, test_b, w_star,
                       gamma: float, *, dtype=None,
                       device="cuda") -> FederatedDataset:
    """FederatedDataset from numpy-convertible client (A_k, b_k) pairs."""
    def t(x):
        return tensor_from_numpy(x, dtype=dtype, device=device)

    return FederatedDataset(
        clients=tuple((t(A), t(b)) for A, b in clients),
        test_A=t(test_A), test_b=t(test_b), w_star=t(w_star),
        gamma=float(gamma))


def engine_from_ledger(clients: Mapping[Hashable, object],
                       dropped: Mapping[Hashable, object], *,
                       dtype=None, device="cuda", **engine_kwargs
                       ) -> FusionEngine:
    """A port engine rebuilt from an exported ``(clients, dropped)`` ledger.

    The fused state is the active clients' statistics ingested in ledger
    order; the per-client ledger (active and dropped) is installed beside
    it, so drop/restore/LOCO continue from where the exporting engine was.
    """
    active = {cid: suffstats_from(s, dtype=dtype, device=device)
              for cid, s in clients.items()}
    gone = {cid: suffstats_from(s, dtype=dtype, device=device)
            for cid, s in dropped.items()}
    any_stats = next(iter({**active, **gone}.values()), None)
    if any_stats is None:
        raise ValueError("empty ledger: no client statistics to rebuild from")
    eng = FusionEngine(any_stats.dim, dtype=any_stats.gram.dtype,
                       device=device, **engine_kwargs)
    for s in active.values():
        eng.ingest(s)
    eng.import_ledger(active, gone)
    return eng


def _policy_from(policy) -> CoalescerPolicy | None:
    return None if policy is None else CoalescerPolicy(
        max_rank=policy.max_rank, max_staleness_s=policy.max_staleness_s)


def pool_from(jpool, arrays: Mapping[str, Sequence] | None = None, *,
              device="cuda") -> EnginePool:
    """A port ``EnginePool`` holding the same tenants as a reference pool.

    The pool keeps the reference's mesh shape (``mesh_from``, on ``device``)
    and ``meshes_built``. Each tenant keeps its placement (a sharded tenant
    keeps its block size and method), coalescer policy, update-rank bound,
    feature map, admission record, streamed-byte count, wire counters, PSD
    guard record and dedup index (so a re-send of a frame the reference fused is a
    duplicate here too), and the pool its limits. A tenant's fused statistics are carried over as they are
    (after draining its queued deltas), so they equal the reference's
    bitwise whatever streamed into it without a client id or was dropped;
    its exported ``(clients, dropped)`` ledger is installed beside them, as
    the reference's own snapshot restore does. A feature tenant's map is
    pinned to ``arrays[name]`` where given, else to the reference map's
    own materialized arrays (``feature_map_from``).
    """
    from repro_torch.fed import comm as fed_comm

    jmesh = getattr(jpool, "_mesh", None)
    pool = EnginePool(
        mesh=None if jmesh is None else mesh_from(jmesh, device=device),
        mesh_devices=getattr(jpool, "_mesh_devices", 8),
        journal_placement=getattr(jpool, "_journal_placement", "dense"),
        threshold=jpool._threshold, table=jpool._table,
        max_warm=jpool.max_warm, max_tenants=jpool.max_tenants,
        stat_budget_bytes=jpool.stat_budget_bytes,
        max_clients_per_tenant=jpool.max_clients_per_tenant,
        default_coalesce=_policy_from(jpool._default_coalesce),
        tier=jpool.tier, device=device)
    pool.meshes_built = getattr(jpool, "meshes_built", 0)
    for name in jpool.tenant_names:
        jt = jpool.tenant(name)
        with jt.lock:
            jeng = jt.engine
            fused = jeng.stats
            clients, dropped = jeng.export_ledger()
            fm = jt.feature_map
            if fm is not None:
                fm = feature_map_from(
                    fm, (arrays or {}).get(name, fm.materialize()),
                    device=device)
            jbe = jeng.backend
            engine = pool.create_tenant(
                name, stats=suffstats_from(fused, device=device),
                placement=jt.placement, features=fm,
                coalesce=_policy_from(jeng.coalesce),
                max_update_rank=jeng.max_update_rank,
                backend_kwargs=({"block_size": jbe.block_size,
                                 "method": jbe.method}
                                if jbe.name == "sharded" else None))
            engine.import_ledger(
                {c: suffstats_from(s, device=device) for c, s in clients.items()},
                {c: suffstats_from(s, device=device) for c, s in dropped.items()})
            t = pool.tenant(name)
            if jt.comm is not None:
                t.comm = getattr(fed_comm, type(jt.comm).__name__)(
                    **dataclasses.asdict(jt.comm))
            t.streamed_floats = jt.streamed_floats
            for field in ("wire_frames", "relay_frames", "wire_upload_bytes",
                          "wire_download_bytes", "duplicates",
                          "psd_repairs", "guard_min_eig"):
                setattr(t, field, getattr(jt, field))
            t.dedup = set(jt.dedup)
    return pool


def mesh_from(jmesh, *, device="cuda") -> Mesh:
    """A port mesh with a reference mesh's axis names and shape, every shard
    on ``device``."""
    return make_mesh(tuple(np.shape(jmesh.devices)), tuple(jmesh.axis_names),
                     device=device)


def sharded_backend_from(jbackend, mesh: Mesh | None = None, *,
                         device="cuda") -> ShardedBackend:
    """A port ``ShardedBackend`` holding a reference sharded backend's fused
    statistics: its gathered (G, h, count) cut into the port's blocks on
    ``mesh`` (default: ``mesh_from`` of the reference's mesh on
    ``device``), with the same dimension, dtype, block size and method."""
    if mesh is None:
        mesh = mesh_from(jbackend.mesh, device=device)
    stats = suffstats_from(jbackend.stats(), device=mesh.distinct_devices[0])
    be = ShardedBackend(jbackend.dim, mesh, dtype=stats.gram.dtype,
                        block_size=jbackend.block_size, method=jbackend.method)
    be.set_stats(stats)
    return be


def key_from(jax_key) -> np.ndarray:
    """A raw uint32 PRNG key pair (e.g. ``jax.random.PRNGKey(s)``) as numpy."""
    arr = np.asarray(jax_key)
    if arr.shape != (2,) or arr.dtype != np.uint32:
        raise TypeError(f"need a raw uint32 key of shape (2,), got {arr.dtype} "
                        f"{arr.shape}")
    return arr.copy()


_MAP_FIELDS = ("kind", "seed", "d_orig", "m", "lengthscale")


def feature_map_from(fm, arrays=None, *, device="cuda") -> features.FeatureMap:
    """The port's ``FeatureMap`` for a reference map (any object with its
    fields ``kind, seed, d_orig, m, lengthscale`` as attributes).

    With ``arrays`` (the reference's materialised (R,) or (W, c), as
    numpy-convertible arrays) the port's map is pinned to exactly those
    bytes, and they are placed on ``device`` at once; without, the port
    draws its own (``core.threefry``).
    """
    port = features.FeatureMap(**{k: getattr(fm, k) for k in _MAP_FIELDS})
    if arrays is not None:
        features.seed_arrays(port, arrays)
        port.materialize(device)
    return port


def model_params_from(params, cfg: ArchConfig, *, device="cuda") -> BackboneLM:
    """The port's model for a reference parameter tree (``init_params``'s
    nested dicts, as numpy-convertible arrays), computing the same function.

    ``params["stages"][i]`` holds pattern position i of every stage along a
    leading ``num_stages`` axis; stage s's layer takes index s of it. Tail,
    embedding (or an ``embeddings``-mode model's top-level ``mask_embed``),
    head and final norm are copied as they are; an encoder's MLP has no
    ``gate``. Weights keep the (in, out) orientation, so nothing is
    transposed; shapes and dtypes must match the model's exactly: the
    config's dtype, but float32 for a Mamba layer's ``A_log`` and ``D`` and
    an RWKV time mix's ``w0``, ``u`` and ``ln_scale`` in every model, as
    the reference keeps them. An RWKV layer's ``rwkv_tm`` and ``rwkv_cm``
    subtrees carry over by name like any other.
    """
    model = BackboneLM(cfg, device=device)
    by_name = dict(model.named_parameters())
    for name, arr in _named_arrays(params, model):
        p = by_name[name]
        want = str(p.dtype).removeprefix("torch.")
        if arr.shape != tuple(p.shape) or arr.dtype.name != want:
            raise ValueError(f"{name}: reference array {arr.dtype} {arr.shape}, "
                             f"model wants {want} {tuple(p.shape)}")
        with torch.no_grad():
            p.copy_(tensor_from_numpy(arr, device=device))
    return model


def _named_arrays(tree, model: BackboneLM):
    """(name, numpy array) for each of ``model``'s parameters: its leaf in a
    tree of the reference's layout, stage s of a stacked stage leaf."""
    for name, _ in model.named_parameters():
        parts = name.split(".")
        if parts[0] == "stages":
            arr, keys, index = tree["stages"][int(parts[2])], parts[3:], int(parts[1])
        elif parts[0] == "tail":
            arr, keys, index = tree["tail"][int(parts[1])], parts[2:], None
        else:
            arr, keys, index = tree, parts, None
        for key in keys:
            arr = arr[key]
        yield name, np.asarray(arr) if index is None else np.asarray(arr)[index]


def _host_array(t: torch.Tensor) -> np.ndarray:
    """A tensor as a host numpy array; bf16 / f16 widened to float32
    (exact), since numpy has no bf16 of its own."""
    t = t.detach()
    if t.dtype in (torch.bfloat16, torch.float16):
        t = t.float()
    return t.cpu().numpy()


def model_tree_of(model: BackboneLM, tensors: Mapping[str, torch.Tensor] | None = None
                  ) -> dict:
    """The reference's nested parameter layout of ``model``'s parameters, or
    of any dict keyed by their names (grads, AdamW's master, m or v), as
    host numpy arrays (bf16 widened to float32): the inverse of
    :func:`model_params_from`. ``"stages"`` is a tuple with one dict per
    stage-pattern position whose leaves stack the stages along a leading
    ``num_stages`` axis; ``"tail"`` a tuple of per-layer dicts
    (``models.model.stacked_tree``)."""
    values = dict(model.named_parameters()) if tensors is None else tensors
    return stacked_tree(model.cfg, {name: _host_array(values[name])
                                    for name, _ in model.named_parameters()}, np.stack)


def named_tensors_from(tree, model: BackboneLM, *, dtype=None) -> dict[str, torch.Tensor]:
    """The leaves of a tree in the reference's parameter layout (its
    parameters, grads, or AdamW's master, m or v) by ``model``'s parameter
    names, on the model's device (``dtype``: the leaf's own by default):
    the inverse of :func:`model_tree_of`."""
    device = next(model.parameters()).device
    return {name: tensor_from_numpy(arr, dtype=dtype, device=device)
            for name, arr in _named_arrays(tree, model)}


def opt_state_from(jax_state, model: BackboneLM) -> dict:
    """The port's AdamW state (``optim.adamw``) for the reference's
    ``{"master", "m", "v", "count"}``: each tree's leaves by the model's
    parameter names as float32 on the model's device, and the count as an
    int32 scalar."""
    state = {key: named_tensors_from(jax_state[key], model, dtype=torch.float32)
             for key in ("master", "m", "v")}
    state["count"] = torch.tensor(int(np.asarray(jax_state["count"])), dtype=torch.int32,
                                  device=next(model.parameters()).device)
    return state
