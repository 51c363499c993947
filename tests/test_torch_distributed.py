"""Port parity for the on-mesh protocol: ``core.distributed_stats``, the
probe on a mesh, and the DP hook on mesh rows.

Mirrors tests/test_distributed.py, whose checks run in a child process with
8 host devices (jax locks its device count at first init). Here one child
per module runs the reference on a (4, 2) mesh with numpy inputs made in the
parent and writes its arrays to an npz; the port runs the same calls on its
(4, 2) CPU mesh (``launch.mesh.make_cpu_mesh(8)``, 8 shards on the CPU):

  1. distributed == local (Thm 1 on the mesh): within the reference's
     1e-4, and within 1e-4 of the reference's own distributed statistics;
  2. the Thm-8 participation mask zeroes a client before the reduction;
  3. Algorithm 2's per-client noise: each client's noise is the
     reference's bits for its flat client index, the hook sees each row
     shard's own statistics under that index, and the result is symmetric;
  4. the one-shot probe on the mesh equals the single-device probe and the
     reference's mesh probe.
"""
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as jcore
from repro.launch import mesh as jmesh_lib
from repro_torch import convert
from repro_torch import core as tcore
from repro_torch.core import probe
from repro_torch.launch import mesh as mesh_lib
from repro_torch.server import FusionEngine, ShardedBackend

TOL = 1e-4

_CHILD = r"""
import sys
import jax, jax.numpy as jnp, numpy as np
from repro import core
from repro.core import probe
from repro.launch import mesh as mesh_lib

assert jax.device_count() == 8, jax.device_count()
mesh = mesh_lib.make_host_mesh((4, 2), ("data", "model"))
inp = dict(np.load(sys.argv[1]))
A, b = jnp.asarray(inp["A"]), jnp.asarray(inp["b"])
out = {}
s = core.distributed_stats(A, b, mesh, client_axes=("data",))
out["gram"], out["moment"], out["count"] = map(np.asarray, (s.gram, s.moment, s.count))
s = core.distributed_stats(A, b, mesh, client_axes=("data",),
                           participation=jnp.array([1., 0., 1., 1.]))
out["gram_p"], out["count_p"] = np.asarray(s.gram), np.asarray(s.count)
nf = core.make_dp_noise_fn(jax.random.PRNGKey(9), 2.0, 1e-5, 16)
for k in range(4):
    g, h = nf(jnp.asarray(k, jnp.int32), jnp.zeros((16, 16), jnp.float32),
              jnp.zeros((16,), jnp.float32))
    out[f"noise{k}_g"], out[f"noise{k}_h"] = np.asarray(g), np.asarray(h)
s = core.distributed_stats(A, b, mesh, client_axes=("data",), noise_fn=nf)
out["gram_dp"], out["moment_dp"] = np.asarray(s.gram), np.asarray(s.moment)
W, y = jnp.asarray(inp["W"]), jnp.asarray(inp["y"])
feat = lambda x: jnp.tanh(x @ W)
out["probe_mesh"] = np.asarray(probe.one_shot_probe(feat, A, y, sigma=0.01,
                                                    mesh=mesh).weights)
np.savez(sys.argv[2], **out)
print("CHILD-OK")
"""


def _inputs(seed=1):
    rng = np.random.default_rng(seed)
    return {"A": rng.standard_normal((256, 16)).astype(np.float32),
            "b": rng.standard_normal(256).astype(np.float32),
            "W": rng.standard_normal((16, 8)).astype(np.float32),
            "y": rng.standard_normal(256).astype(np.float32)}


@pytest.fixture(scope="module")
def ref8(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("distributed8")
    inp = _inputs()
    np.savez(tmp / "in.npz", **inp)
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = str(pathlib.Path(__file__).resolve().parents[1] / "src")
    run = subprocess.run([sys.executable, "-c", _CHILD, str(tmp / "in.npz"),
                          str(tmp / "out.npz")],
                         env=env, capture_output=True, text=True, timeout=600)
    assert "CHILD-OK" in run.stdout, run.stdout + run.stderr
    inp_t = {k: torch.from_numpy(v) for k, v in inp.items()}
    return inp_t, dict(np.load(tmp / "out.npz"))


@pytest.fixture(scope="module")
def mesh():
    return mesh_lib.make_host_mesh((4, 2), ("data", "model"))


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol, atol=tol)


def test_distributed_equals_local(ref8, mesh):
    inp, out = ref8
    s = tcore.distributed_stats(inp["A"], inp["b"], mesh, client_axes=("data",))
    local = tcore.compute_stats(inp["A"], inp["b"])
    _close(s.gram, local.gram)
    _close(s.moment, local.moment)
    _close(s.gram, out["gram"])
    _close(s.moment, out["moment"])
    # the count is the participation-weighted float, as the reference's
    assert s.count.dtype == torch.float32 and out["count"].dtype == np.float32
    assert float(s.count) == float(out["count"]) == 256.0


def test_participation_mask_drops_a_client(ref8, mesh):
    inp, out = ref8
    s = tcore.distributed_stats(inp["A"], inp["b"], mesh, client_axes=("data",),
                                participation=torch.tensor([1., 0., 1., 1.]))
    keep = np.r_[0:64, 128:256]
    ref = tcore.compute_stats(inp["A"][keep], inp["b"][keep])
    _close(s.gram, ref.gram)
    _close(s.gram, out["gram_p"])
    assert float(s.count) == float(out["count_p"]) == 192.0


def test_dp_noise_is_the_reference_bits_per_client(ref8, mesh):
    inp, out = ref8
    nf = tcore.make_dp_noise_fn(convert.key_from(jax.random.PRNGKey(9)),
                                2.0, 1e-5, 16)
    for k in range(4):
        g, h = nf(k, torch.zeros(16, 16), torch.zeros(16))
        np.testing.assert_array_equal(g.numpy(), out[f"noise{k}_g"])
        np.testing.assert_array_equal(h.numpy(), out[f"noise{k}_h"])
    seen = []

    def recording(idx, G, h):
        seen.append((idx, G.clone()))
        return nf(idx, G, h)

    s = tcore.distributed_stats(inp["A"], inp["b"], mesh, client_axes=("data",),
                                noise_fn=recording)
    assert [i for i, _ in seen] == [0, 1, 2, 3]
    for k, G in seen:
        rows = slice(64 * k, 64 * (k + 1))
        assert torch.equal(G, tcore.compute_stats(inp["A"][rows], inp["b"][rows]).gram)
    g = s.gram.numpy()
    assert not np.allclose(g, tcore.compute_stats(inp["A"], inp["b"]).gram.numpy())
    np.testing.assert_allclose(g, g.T, atol=1e-4)
    assert s.yty is None
    # the reference's sum of noisy client statistics, up to the order of adds
    np.testing.assert_allclose(g, out["gram_dp"], rtol=1e-5, atol=1e-2)
    np.testing.assert_allclose(s.moment.numpy(), out["moment_dp"], rtol=1e-5, atol=1e-2)


def test_fuse_distributed_takes_the_noise_hook_per_row_shard(mesh):
    inp = {k: torch.from_numpy(v) for k, v in _inputs().items()}
    nf = tcore.make_dp_noise_fn(convert.key_from(jax.random.PRNGKey(9)),
                                2.0, 1e-5, 16)
    seen = []

    def recording(idx, G, h):
        seen.append(idx)
        return nf(idx, G, h)

    be = ShardedBackend(16, mesh)
    FusionEngine(16, backend=be, device="cpu").ingest_distributed(
        inp["A"], inp["b"], noise_fn=recording)
    assert seen == [0, 1, 2, 3]
    want = tcore.distributed_stats(inp["A"], inp["b"], mesh, noise_fn=nf)
    _close(be.stats().gram, want.gram, tol=1e-3)


def test_distributed_matches_reference_in_process(ref8, mesh):
    """The reference's in-process mesh is 1 x 1 (one host device)."""
    inp, _ = ref8
    jm = jmesh_lib.make_host_mesh((1, 1), ("data", "model"))
    js = jcore.distributed_stats(jnp.asarray(inp["A"].numpy()),
                                 jnp.asarray(inp["b"].numpy()), jm)
    s = tcore.distributed_stats(inp["A"], inp["b"], mesh)
    _close(s.gram, js.gram)
    s1 = tcore.distributed_stats(inp["A"], inp["b"], mesh_lib.make_cpu_mesh(1))
    np.testing.assert_array_equal(s1.gram.numpy(),
                                  tcore.compute_stats(inp["A"], inp["b"]).gram.numpy())


def test_one_shot_probe_on_the_mesh(ref8, mesh):
    inp, out = ref8
    W = inp["W"]

    def feat(x):
        return torch.tanh(x @ W)

    r_mesh = probe.one_shot_probe(feat, inp["A"], inp["y"], sigma=0.01, mesh=mesh)
    r_local = probe.one_shot_probe(feat, inp["A"], inp["y"], sigma=0.01)
    np.testing.assert_allclose(r_mesh.weights.numpy(), r_local.weights.numpy(),
                               rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(r_mesh.weights.numpy(), out["probe_mesh"],
                               rtol=1e-3, atol=1e-4)
    assert int(r_mesh.stats.count) == 256
    # a feature function with several feature rows an input row (per-token
    # features of a prompt): each array splits by its own length
    X3 = inp["A"].reshape(64, 4, 16)

    def per_token(x):
        return torch.tanh(x @ W).reshape(-1, W.shape[1])

    r3 = probe.one_shot_probe(per_token, X3, inp["y"], sigma=0.01, mesh=mesh)
    np.testing.assert_allclose(r3.weights.numpy(), r_local.weights.numpy(),
                               rtol=1e-3, atol=1e-4)
    with pytest.raises(ValueError, match="do not split"):
        probe.one_shot_probe(feat, inp["A"][:250], inp["y"][:250], mesh=mesh)
