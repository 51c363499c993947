"""One-shot federated linear probing of backbone features.

This is where the paper's technique meets the model zoo: the nonlinear
backbone f_theta is frozen; the readout head IS a ridge regression on
features Phi = f_theta(x) in R^{d_feat}, so Theorems 1/2/5/8 apply verbatim
to the head. One aggregation of (d_feat^2 + d_feat) floats replaces
iterative head training. Multi-target heads (e.g. num_classes regression
targets) are supported by stacking moment vectors.

The Gram of the features is a float32 ``torch.matmul`` (TF32 off,
``repro_torch``'s default), as the reference's einsum is, and the head is
solved by Cholesky. With ``mesh=`` the rows are split over the mesh's
client axes, the feature function runs on each row shard on that shard's
device, and the shards' feature statistics are added in flat shard order:
the one fusion round. A backbone the feature function closes over lives
on one device; :func:`replicas` puts a copy of it on each other device of
the mesh (JAX copies a closed-over backbone onto every device itself).
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Callable

import torch
from torch import nn

from repro_torch.core.fusion import cholesky_or_nan
from repro_torch.core.sufficient_stats import SuffStats


@dataclasses.dataclass(frozen=True)
class ProbeResult:
    weights: torch.Tensor       # (d_feat,) or (d_feat, n_targets)
    stats: SuffStats            # fused feature statistics (reusable for LOCO-CV)
    sigma: float


def _feature_stats(feats: torch.Tensor, targets: torch.Tensor) -> SuffStats:
    """Stats on features; targets may be (n,) or (n, t) (stacked moments).

    Products accumulate in float32: the features are widened first (a
    product of two bf16 values is exact in float32).
    """
    F = feats.to(torch.float32)
    gram = F.T @ F
    moment = F.T @ targets.to(torch.float32)
    # torch.full, not torch.tensor: a copy from the host would wait for the
    # device's queued work, and serialise the shards of a mesh of cards
    return SuffStats(gram, moment, torch.full((), feats.shape[0], dtype=torch.int32,
                                              device=feats.device))


def solve_head(stats: SuffStats, sigma: float) -> torch.Tensor:
    """(G + sigma I)^{-1} H for single- or multi-target moments."""
    G, H = stats.gram, stats.moment
    reg = G + sigma * torch.eye(G.shape[0], dtype=G.dtype, device=G.device)
    L = cholesky_or_nan(reg)
    w = torch.cholesky_solve(H[:, None] if H.ndim == 1 else H, L)
    return w[:, 0] if H.ndim == 1 else w


def replicas(module: nn.Module, devices) -> dict[torch.device, nn.Module]:
    """One frozen copy of ``module`` on each distinct device of ``devices``
    (a list of devices, or a ``launch.mesh.Mesh``): ``module`` itself on
    its own device, elsewhere a copy whose parameters and buffers are its
    bits, broadcast from its device (``launch.mesh.broadcast``, so the
    bytes count in ``collective_bytes()``). On a mesh of one device
    nothing is copied. The port's counterpart of JAX's copying a
    closed-over backbone onto every device of a ``shard_map``."""
    from repro_torch.launch import mesh as mesh_lib

    if hasattr(devices, "distinct_devices"):
        devices = devices.distinct_devices
    home = next(module.parameters()).device
    others = [d for d in dict.fromkeys(mesh_lib._device(d) for d in devices) if d != home]
    out = {home: module}
    if not others:
        return out
    tensors = list(module.parameters()) + list(module.buffers())
    copies = {id(t): mesh_lib.broadcast(t.detach(), others) for t in tensors}
    for i, dev in enumerate(others):
        memo = {}
        for t in module.parameters():
            memo[id(t)] = nn.Parameter(copies[id(t)][i], requires_grad=False)
        for t in module.buffers():
            memo[id(t)] = copies[id(t)][i]
        out[dev] = copy.deepcopy(module, memo).eval()
    return out


def one_shot_probe(
    feature_fn: Callable[[torch.Tensor], torch.Tensor],
    inputs: torch.Tensor,
    targets: torch.Tensor,
    *,
    sigma: float = 1e-2,
    mesh=None,
    client_axes: tuple[str, ...] = ("data",),
) -> ProbeResult:
    """Fit a ridge readout head on frozen backbone features, one-shot.

    Args:
      feature_fn: frozen backbone, maps (n, ...) inputs -> (n, d_feat)
        features.
      inputs / targets: without ``mesh`` everything runs on one device (the
        K=1 degenerate case — still the exact centralized solution, by
        Thm 2); with a ``launch.mesh.Mesh`` the rows of each split evenly
        over the shards along ``client_axes`` (each by its own length, so a
        feature function may give several feature rows an input row, as
        per-token features of a prompt), each shard's features and
        statistics are computed on its device, and one reduction fuses them.
        ``feature_fn`` is called with each shard's rows on that shard's
        device; a backbone on one device runs there through its copy from
        :func:`replicas`: ``reps = replicas(model, mesh)`` and then
        ``feature_fn = lambda x: features(reps[x.device], x)``. The shards'
        statistics are added in flat shard order on shard 0's device.
    """
    if mesh is None:
        stats = _feature_stats(feature_fn(inputs), targets)
        return ProbeResult(solve_head(stats, sigma), stats, sigma)
    from repro_torch.launch import mesh as mesh_lib

    k_all = mesh_lib.axis_size(mesh, client_axes)
    for t in (inputs, targets):
        if t.shape[0] % k_all:
            raise ValueError(f"{t.shape[0]} rows do not split over {k_all} "
                             f"shards along {client_axes}")
    rows, trows = inputs.shape[0] // k_all, targets.shape[0] // k_all
    local = []
    for k in range(k_all):
        dev = mesh.device_at(mesh_lib.unflatten(mesh, client_axes, k))
        x_k = inputs[k * rows:(k + 1) * rows].to(dev)
        local.append(_feature_stats(feature_fn(x_k),
                                    targets[k * trows:(k + 1) * trows].to(dev)))
    dev = local[0].gram.device
    fused = SuffStats(mesh_lib.psum([s.gram for s in local], dev),
                      mesh_lib.psum([s.moment for s in local], dev),
                      mesh_lib.psum([s.count for s in local], dev))
    return ProbeResult(solve_head(fused, sigma), fused, sigma)


def probe_mse(feature_fn, inputs, targets, result: ProbeResult) -> torch.Tensor:
    pred = feature_fn(inputs).to(result.weights.dtype) @ result.weights
    return torch.mean((pred - targets) ** 2)


def head_as_params(result: ProbeResult) -> dict:
    """Package the fused head so checkpointing/serving treats it as a layer."""
    w = result.weights
    return {"kernel": w if w.ndim == 2 else w[:, None],
            "bias": torch.zeros((w.shape[1] if w.ndim == 2 else 1,),
                                dtype=w.dtype, device=w.device)}
