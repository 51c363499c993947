"""``probe.replicas`` and the one-shot probe on a mesh, against the reference.

- On a CPU mesh ``replicas`` gives the module itself: nothing copied, no
  bytes counted. To another device (``meta`` here, on the CPU) it gives a
  copy of the same parameter names and shapes, frozen, whose bytes the
  broadcast counts; the original is untouched. (tests/test_torch_cuda.py
  holds a copy's bits on the mesh of cuda:0 and the host.)
- The port's ``one_shot_probe`` on ``make_cpu_mesh(8)`` with reduced
  gemma3 (the reference's ``init_params`` carried over by
  ``convert.model_params_from``), 4 clients along ``data``, each shard's
  features through its device's replica, against the reference's
  ``one_shot_probe`` on a real (4, 2) mesh of 8 host devices in a child
  process: predictions within 1e-4 relative and the head within 1e-3 of
  the float64 central head (tests/test_torch_probe.py's tolerances).
"""
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.core import probe
from repro_torch.launch import mesh as mesh_lib
from test_torch_probe import _gemma, _jax_features, _port_features, _rel

ROOT = Path(__file__).resolve().parents[1]
SIGMA = 1.0

_CHILD = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax
import jax.numpy as jnp
import numpy as np
from repro import configs
from repro.core import probe
from repro.launch import mesh as mesh_lib
from repro.models import blocks, layers, model

assert len(jax.devices()) == 8
cfg = configs.get_reduced("gemma3-27b")
params = model.init_params(jax.random.PRNGKey(0), cfg)

def features(tokens):
    x = model._input_embeddings(params, {"tokens": tokens}, cfg)
    for s in range(cfg.num_stages):
        for pos, spec in enumerate(cfg.stage_pattern):
            layer = jax.tree.map(lambda a, s=s: a[s], params["stages"][pos])
            x = blocks.apply_layer(layer, x, cfg, spec, chunk_size=16, collect_aux=None)
    for pos, spec in enumerate(cfg.tail_pattern):
        x = blocks.apply_layer(params["tail"][pos], x, cfg, spec, chunk_size=16,
                               collect_aux=None)
    return layers.rmsnorm(params["final_norm"], x, cfg.norm_eps).reshape(-1, cfg.d_model)

data = np.load(sys.argv[1])
mesh = mesh_lib.make_host_mesh((4, 2))
out = {}

@jax.jit
def fit(tokens, y):
    r = probe.one_shot_probe(features, tokens, y, sigma=float(data["sigma"]), mesh=mesh)
    return r.weights, r.stats.count

for key in ("y1", "y4"):
    w, n = fit(jnp.asarray(data["tokens"]), jnp.asarray(data[key]))
    out["weights_" + key], out["count_" + key] = np.asarray(w), np.asarray(n)
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """Prompts, 1-D and (n, 4) targets made from the reference's features,
    and the reference's mesh probe of each in one child process."""
    params, _, jcfg = _gemma()
    rng = np.random.default_rng(1)
    toks = rng.integers(0, 512, (8, 48)).astype(np.int32)     # 4 clients x 2 prompts
    fj = np.asarray(_jax_features(params, jcfg, jnp.asarray(toks)), np.float32)
    ys = {}
    for t in ((), (4,)):
        w_true = rng.standard_normal((jcfg.d_model, *t)).astype(np.float32)
        ys[f"y{t[0] if t else 1}"] = fj @ w_true + 0.01 * rng.standard_normal(
            (fj.shape[0], *t)).astype(np.float32)
    tmp = tmp_path_factory.mktemp("probe_mesh")
    np.savez(tmp / "in.npz", tokens=toks, sigma=SIGMA, **ys)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    run = subprocess.run([sys.executable, "-c", _CHILD, str(tmp / "in.npz"),
                          str(tmp / "out.npz")], env=env, capture_output=True,
                         text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-4000:]
    return toks, fj, ys, dict(np.load(tmp / "out.npz"))


def test_replicas_on_a_cpu_mesh_are_the_module_itself():
    _, lm, _ = _gemma()
    mesh_lib.reset_collective_bytes()
    for devices in (mesh_lib.make_cpu_mesh(8), ["cpu", torch.device("cpu")]):
        reps = probe.replicas(lm, devices)
        assert list(reps) == [torch.device("cpu")] and reps[torch.device("cpu")] is lm
    assert all(n == 0 for n in mesh_lib.collective_bytes().values())


def test_replica_on_another_device_is_a_frozen_copy():
    _, lm, _ = _gemma()
    before = [p.clone() for p in lm.parameters()]
    mesh_lib.reset_collective_bytes()
    reps = probe.replicas(lm, ["cpu", "meta"])
    meta = torch.device("meta")
    assert list(reps) == [torch.device("cpu"), meta] and reps[meta] is not lm
    assert mesh_lib.collective_bytes()["broadcast"] == sum(
        p.numel() * p.element_size() for p in lm.parameters())
    pairs = list(zip(lm.named_parameters(), reps[meta].named_parameters()))
    assert len(pairs) == len(before) > 0
    for (n, p), (m, q) in pairs:
        assert n == m and q.shape == p.shape and q.dtype == p.dtype
        assert q.device == meta and not q.requires_grad and p.device.type == "cpu"
    assert all(torch.equal(a, p) for a, p in zip(before, lm.parameters()))
    assert reps[meta].cfg == lm.cfg and not reps[meta].training


@pytest.mark.parametrize("key", ["y1", "y4"])
def test_mesh_probe_through_replicas_matches_the_reference_mesh(key, reference):
    toks, fj, ys, ref = reference
    _, lm, _ = _gemma()
    y = ys[key]
    mesh = mesh_lib.make_cpu_mesh(8)
    reps = probe.replicas(lm, mesh)
    seen = []

    def feature_fn(t):
        seen.append(tuple(t.shape))
        with torch.no_grad():
            return _port_features(reps[t.device], t)
    rt = probe.one_shot_probe(feature_fn, torch.from_numpy(toks), torch.from_numpy(y),
                              sigma=SIGMA, mesh=mesh)
    assert seen == [(2, 48)] * 4                       # one client a data row
    assert int(rt.stats.count) == int(ref[f"count_{key}"]) == 8 * 48
    assert rt.weights.shape == ref[f"weights_{key}"].shape
    with torch.no_grad():
        ft = _port_features(lm, torch.from_numpy(toks)).float()
    assert _rel(ft.numpy() @ rt.weights.numpy(), fj @ ref[f"weights_{key}"]) <= 1e-4
    F = ft.double()
    w64 = torch.linalg.solve(F.T @ F + SIGMA * torch.eye(F.shape[1], dtype=torch.float64),
                             F.T @ torch.from_numpy(y).double())
    assert _rel(rt.weights, w64) <= 1e-3
