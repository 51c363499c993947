"""The sharded backend's collectives across devices, on the CPU.

The port's meshes may spread over the cards of one host
(``launch.mesh.make_device_mesh(8, devices=...)``: row i of the (4, 2) mesh
on card i). Here, with no card, the same code runs on meshes whose devices
repeat, on ``meta`` (where reading a value back raises), and with consumers
on ``meta`` beside the CPU:

  * the collectives give today's bits on a repeated-device mesh (a left
    fold in flat shard order, a concatenation, the fold's slices), and each
    result lies on its consumer's device;
  * the byte counter reads 0 where no two shards' devices differ, and
    counts exactly the pieces that cross devices where they do;
  * ``fuse_distributed`` never sums or holds a (dp, dp) tensor, and its
    blocks on the port's (4, 2) CPU mesh are the reference's
    ``psum_scatter`` blocks on 8 JAX host devices, bit for bit (one child
    process runs the reference, as ``tests/test_torch_distributed.py``
    does; the clients' statistics are set by the noise hook, so that the
    sums alone decide the bits);
  * the per-device loops of the backend read no value back (a mesh of
    ``meta`` shards runs fusion, factor, solve and update);
  * a mesh over several cards places whole rows on each, and the pool's
    mesh spreads over every visible card for ``"cuda"``.
"""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import core as tcore
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.sharding import P, ShardedTensor
from repro_torch.server import FusionEngine, ShardedBackend
from repro_torch.server import distributed

CPU, META = torch.device("cpu"), torch.device("meta")


def _parts(k=4, shape=(8, 6), seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            for _ in range(k)]


def _fold(parts):
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    return total


@pytest.fixture(autouse=True)
def _zero_bytes():
    mesh_lib.reset_collective_bytes()
    yield
    mesh_lib.reset_collective_bytes()


# ---------------------------------------------------------------------------
# The collectives
# ---------------------------------------------------------------------------

class TestCollectives:
    @pytest.mark.parametrize("k", [1, 3, 4])
    def test_psum_on_one_device_is_the_left_fold(self, k):
        parts = _parts(k)
        assert torch.equal(mesh_lib.psum(parts), _fold(parts))
        out = mesh_lib.psum(parts, devices=[CPU, CPU])
        assert len(out) == 2 and all(torch.equal(o, _fold(parts)) for o in out)

    @pytest.mark.parametrize("shape", [(8, 6), (5, 3), (16,), (3,)])
    def test_psum_reduce_scatter_all_gather_keeps_the_bits(self, shape):
        """Consumers on two devices: slice j of every part added on part j's
        device, the slices gathered onto each consumer; the CPU copy is the
        fold bit for bit, the other lies on its device."""
        parts = _parts(4, shape, seed=1)
        cpu, meta = mesh_lib.psum(parts, devices=[CPU, META])
        assert torch.equal(cpu, _fold(parts))
        assert meta.device == META and meta.shape == cpu.shape
        # the meta copy is each slice once
        assert mesh_lib.collective_bytes()["psum"] == 4 * int(np.prod(shape))

    def test_psum_of_scalars_to_several_consumers(self):
        parts = [torch.tensor(float(i)) for i in range(4)]
        cpu, meta = mesh_lib.psum(parts, devices=[CPU, META])
        assert float(cpu) == 6.0 and meta.device == META

    @pytest.mark.parametrize("dim", [0, 1])
    def test_all_gather_on_each_consumer(self, dim):
        parts = _parts(3, seed=2)
        assert torch.equal(mesh_lib.all_gather(parts, dim=dim), torch.cat(parts, dim))
        cpu, meta = mesh_lib.all_gather(parts, dim=dim, devices=[CPU, META])
        assert torch.equal(cpu, torch.cat(parts, dim))
        assert meta.device == META and meta.shape == cpu.shape
        assert mesh_lib.collective_bytes()["all_gather"] == 3 * 8 * 6 * 4

    @pytest.mark.parametrize("dim", [0, 1])
    def test_psum_scatter_slices_on_their_devices(self, dim):
        """Slice j on its own device, summed there; the CPU slices are the
        fold's, and only the slices bound for another device move."""
        parts = _parts(2, (8, 8), seed=3)
        parts = parts + [p.clone() for p in parts]
        devices = [CPU, META, CPU, META]
        sl = mesh_lib.psum_scatter(parts, dim=dim, devices=devices)
        assert [s.device for s in sl] == devices
        want = torch.chunk(_fold(parts), 4, dim=dim)
        assert torch.equal(sl[0], want[0]) and torch.equal(sl[2], want[2])
        assert mesh_lib.collective_bytes()["psum_scatter"] == 2 * 4 * 16 * 4

    def test_psum_scatter_on_one_device_is_views_of_one_sum(self):
        parts = _parts(4, (8, 8), seed=4)
        sl = mesh_lib.psum_scatter(parts)
        assert all(torch.equal(s, w) for s, w in zip(sl, torch.chunk(_fold(parts), 4)))
        assert len({s.untyped_storage().data_ptr() for s in sl}) == 1
        assert mesh_lib.collective_bytes()["psum_scatter"] == 0

    def test_broadcast_and_send(self):
        x = _parts(1)[0]
        a, m, b = mesh_lib.broadcast(x, [CPU, META, CPU])
        assert a is x and b is x and m.device == META
        assert mesh_lib.send(x, CPU) is x
        assert mesh_lib.send(x, META).device == META
        assert mesh_lib.collective_bytes() == {
            "psum": 0, "all_gather": 0, "psum_scatter": 0,
            "broadcast": x.numel() * 4, "send": x.numel() * 4}

    def test_reset(self):
        mesh_lib.send(_parts(1)[0], META)
        assert mesh_lib.collective_bytes()["send"] > 0
        mesh_lib.reset_collective_bytes()
        assert set(mesh_lib.collective_bytes().values()) == {0}


# ---------------------------------------------------------------------------
# Meshes over several cards
# ---------------------------------------------------------------------------

class TestMeshOverCards:
    @pytest.mark.parametrize("cards", [1, 2, 4, 8])
    def test_shard_s_on_card_s_c_over_n(self, cards):
        devs = [torch.device("cuda", i) for i in range(cards)]
        m = mesh_lib.make_device_mesh(8, devices=devs)
        assert m.shape == {"data": 4, "model": 2}
        flat = list(m.devices.reshape(-1))
        assert flat == [devs[s * cards // 8] for s in range(8)]
        assert m.distinct_devices == devs
        if cards == 4:                  # row i on card i
            assert all(m.device_at({"data": i, "model": j}) == devs[i]
                       for i in range(4) for j in range(2))

    def test_refuses_more_devices_than_shards(self):
        with pytest.raises(ValueError, match="devices for"):
            mesh_lib.make_device_mesh(2, devices=["cpu"] * 3)
        with pytest.raises(ValueError, match="devices for"):
            mesh_lib.make_device_mesh(2, devices=[])

    def test_spread_devices(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
        assert mesh_lib.spread_devices("cuda") == [torch.device("cuda", i)
                                                   for i in range(4)]
        assert mesh_lib.spread_devices("cuda:0") == [torch.device("cuda", 0)]
        assert mesh_lib.spread_devices("cuda:2") == [torch.device("cuda", 2)]
        assert mesh_lib.spread_devices("cpu") == [CPU]

    @pytest.mark.parametrize("device,want", [("cuda", 4), ("cuda:0", 1), ("cpu", 1)])
    def test_pool_mesh_spreads_over_the_cards(self, monkeypatch, device, want):
        from repro_torch.server import EnginePool

        monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
        pool = EnginePool(device=device)
        try:
            m = pool.shared_mesh()
            assert m.shape == {"data": 4, "model": 2}
            assert len(m.distinct_devices) == want
            assert pool.shared_mesh() is m and pool.meshes_built == 1
        finally:
            pool.close()

    def test_serve_help_names_the_spread(self):
        src = (pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch"
               / "launch" / "serve.py").read_text()
        assert "8 shards over every visible card for --device" in src


# ---------------------------------------------------------------------------
# The backend
# ---------------------------------------------------------------------------

def _problem(n=256, d=100, seed=0):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)),
            torch.from_numpy(rng.standard_normal(n).astype(np.float32)))


class TestBackendBytes:
    def test_no_bytes_move_on_a_one_device_mesh(self):
        mesh = mesh_lib.make_cpu_mesh(8)
        A, b = _problem()
        be = ShardedBackend(100, mesh)
        eng = FusionEngine(100, backend=be, device="cpu")
        eng.ingest_distributed(A, b)
        eng.solve(0.1)
        eng.ingest_rows(A[:3], b[:3])
        eng.solve(0.1)
        FusionEngine.from_stats(eng.stats, backend=ShardedBackend(
            100, mesh, method="cg")).solve(0.1)
        assert eng.incremental_updates == 1
        assert set(mesh_lib.collective_bytes().values()) == {0}


class TestFuseDistributed:
    def test_never_sums_or_holds_the_fused_gram(self, monkeypatch):
        """Every tensor a collective receives or returns during the fusion
        is at most a column strip (dp, cl); the sums it returns are blocks,
        h and the count."""
        seen = []

        def spy(name, fn):
            def wrapped(*args, **kw):
                out = fn(*args, **kw)
                ins = args[0] if isinstance(args[0], (list, tuple)) else [args[0]]
                res = out if isinstance(out, (list, tuple)) else [out]
                seen.append((name, [tuple(t.shape) for t in ins],
                             [tuple(t.shape) for t in res]))
                return out
            return wrapped

        for name in mesh_lib.COLLECTIVES:
            monkeypatch.setattr(mesh_lib, name, spy(name, getattr(mesh_lib, name)))
        mesh = mesh_lib.make_cpu_mesh(8)
        be = ShardedBackend(100, mesh)
        dp = be.padded
        A, b = _problem()
        be.fuse_distributed(A, b)
        assert seen and {n for n, *_ in seen} <= {"psum_scatter", "psum", "send"}
        for name, ins, outs in seen:
            assert (dp, dp) not in ins + outs, (name, ins, outs)
            if name == "psum_scatter":
                assert set(ins) == {(dp, be._cl)} and set(outs) == {(be._rl, be._cl)}
            if name == "psum":
                assert all(len(s) <= 1 for s in ins + outs), (name, ins)
        G = be.gram.full()
        want = tcore.compute_stats(A, b).gram
        np.testing.assert_allclose(G[:100, :100].numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-3)

    @pytest.mark.parametrize("participation", [None, [1.0, 0.0, 1.0, 1.0]])
    def test_row_sharded_input_is_the_plain_inputs_bits(self, participation):
        """Rows given as a row-sharded ShardedTensor fuse to the bits of the
        same rows given whole and split evenly."""
        mesh = mesh_lib.make_cpu_mesh(8)
        A, b = _problem()
        one, two = ShardedBackend(100, mesh), ShardedBackend(100, mesh)
        one.fuse_distributed(A, b, participation=participation)
        two.fuse_distributed(ShardedTensor.distribute(A, mesh, P("data")),
                             ShardedTensor.distribute(b, mesh, P("data")),
                             participation=participation)
        assert all(torch.equal(one.gram.blocks[k], two.gram.blocks[k])
                   for k in one.gram.blocks)
        assert torch.equal(one._h, two._h) and torch.equal(one.count, two.count)

    def test_row_sharded_input_must_shard_the_client_axes(self):
        mesh = mesh_lib.make_cpu_mesh(8)
        A, b = _problem()
        be = ShardedBackend(100, mesh)
        with pytest.raises(ValueError, match="clients along"):
            be.fuse_distributed(ShardedTensor.distribute(A, mesh, P("model")),
                                ShardedTensor.distribute(b, mesh, P("model")))

    def test_fuse_local_takes_one_statistic_a_row_shard(self):
        be = ShardedBackend(100, mesh_lib.make_cpu_mesh(8))
        with pytest.raises(ValueError, match="row shards"):
            be.fuse_local([tcore.compute_stats(*_problem())])

    def test_unscaled_gram_without_participation(self):
        """Without a participation mask the clients' Grams are not scaled:
        a weight of one keeps the bits, and no d x d copy is made."""
        mesh = mesh_lib.make_cpu_mesh(8)
        A, b = _problem()
        local = tcore.sufficient_stats.client_stats(A, b, mesh)
        ones = tcore.sufficient_stats.client_stats(A, b, mesh,
                                                   participation=[1.0] * 4)
        for s, t in zip(local, ones):
            assert torch.equal(s.gram, t.gram) and torch.equal(s.count, t.count)
            assert s.count.dtype == torch.float32


_CHILD = r"""
import sys
import jax, jax.numpy as jnp, numpy as np
from repro.launch import mesh as mesh_lib
from repro.server import FusionEngine, ShardedBackend

assert jax.device_count() == 8, jax.device_count()
mesh = mesh_lib.make_cpu_mesh(8)
inp = dict(np.load(sys.argv[1]))
out = {}
for d in (100, 64):
    E, e = jnp.asarray(inp[f"E{d}"]), jnp.asarray(inp[f"e{d}"])
    for tag, part in (("all", None), ("masked", jnp.array([1., 1., 0., 1.]))):
        be = ShardedBackend(d, mesh)
        eng = FusionEngine(d, backend=be)
        eng.ingest_distributed(jnp.asarray(inp[f"A{d}"]), jnp.asarray(inp[f"b{d}"]),
                               participation=part,
                               noise_fn=lambda idx, G, h: (E[idx], e[idx]))
        G = np.asarray(be.gram)
        out[f"G_{d}_{tag}"], out[f"h_{d}_{tag}"] = G, np.asarray(be._h)
        out[f"count_{d}_{tag}"] = np.asarray(be.count)
        out[f"layout_{d}"] = np.array([be.padded, be._rl, be._cl])
        out[f"shards_{d}_{tag}"] = np.array(sorted(
            (s.index[0].start or 0, s.index[1].start or 0, *s.data.shape)
            for s in be.gram.addressable_shards))
np.savez(sys.argv[2], **out)
print("CHILD-OK")
"""


def _ref_inputs():
    rng = np.random.default_rng(7)
    out = {}
    for d in (100, 64):
        # the clients' statistics, set through the noise hook: large enough
        # that the order of the adds shows in the bits
        out[f"E{d}"] = (rng.standard_normal((4, d, d)) * 1e3).astype(np.float32)
        out[f"e{d}"] = rng.standard_normal((4, d)).astype(np.float32)
        out[f"A{d}"] = rng.standard_normal((256, d)).astype(np.float32)
        out[f"b{d}"] = rng.standard_normal(256).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def ref8(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("multicard8")
    inp = _ref_inputs()
    np.savez(tmp / "in.npz", **inp)
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = str(pathlib.Path(__file__).resolve().parents[1] / "src")
    run = subprocess.run([sys.executable, "-c", _CHILD, str(tmp / "in.npz"),
                          str(tmp / "out.npz")],
                         env=env, capture_output=True, text=True, timeout=600)
    assert "CHILD-OK" in run.stdout, run.stdout + run.stderr
    return inp, dict(np.load(tmp / "out.npz"))


class TestAgainstTheReferencesReduceScatter:
    @pytest.mark.parametrize("d", [100, 64])
    @pytest.mark.parametrize("tag", ["all", "masked"])
    def test_blocks_bitwise(self, ref8, d, tag):
        inp, out = ref8
        E = torch.from_numpy(inp[f"E{d}"])
        e = torch.from_numpy(inp[f"e{d}"])
        mesh = mesh_lib.make_cpu_mesh(8)
        be = ShardedBackend(d, mesh)
        eng = FusionEngine(d, backend=be, device="cpu")
        eng.ingest_distributed(torch.from_numpy(inp[f"A{d}"]),
                               torch.from_numpy(inp[f"b{d}"]),
                               participation=None if tag == "all" else [1., 1., 0., 1.],
                               noise_fn=lambda k, G, h: (E[k], e[k]))
        assert [be.padded, be._rl, be._cl] == out[f"layout_{d}"].tolist()
        G = out[f"G_{d}_{tag}"]
        rl, cl = be._rl, be._cl
        shards = {(int(r0), int(c0)) for r0, c0, *_ in out[f"shards_{d}_{tag}"]}
        assert shards == {(ri * rl, ci * cl) for ri in range(4) for ci in range(2)}
        for (ri, ci), blk in be.gram.blocks.items():
            np.testing.assert_array_equal(
                blk.numpy(), G[ri * rl:(ri + 1) * rl, ci * cl:(ci + 1) * cl])
        np.testing.assert_array_equal(be._h.numpy(), out[f"h_{d}_{tag}"])
        assert int(be.count) == int(out[f"count_{d}_{tag}"])


# ---------------------------------------------------------------------------
# No value read back inside the per-device loops
# ---------------------------------------------------------------------------

class TestNoHostSync:
    @pytest.mark.parametrize("d,bs", [(64, 8), (100, None)])
    def test_sharded_path_runs_on_meta_shards(self, d, bs):
        """On ``meta`` every read of a value (``.item()``, ``float()``, a
        boolean-mask index) raises: fusion, the factor, its solve and a
        rank-r update run there, so they issue each device's work without
        waiting for any."""
        mesh = mesh_lib.make_device_mesh(8, device="meta")
        be = ShardedBackend(d, mesh, block_size=bs)
        A = torch.empty(256, d, device="meta")
        b = torch.empty(256, device="meta")
        be.fuse_distributed(A, b)
        be.fuse(tcore.SuffStats(torch.empty(d, d, device="meta"),
                                torch.empty(d, device="meta"),
                                torch.zeros((), dtype=torch.int32, device="meta")))
        f = be.factor(0.1)
        assert be.solve(f).shape == (d,)
        g = be.update(f, torch.empty(4, d, device="meta"), 1.0)
        assert be.solve(g).device == META
        assert be._matvec(torch.empty(be.padded, device="meta")).shape == (be.padded,)

    def test_a_boolean_mask_would_be_caught(self):
        g = torch.zeros(4, 4, device="meta")
        with pytest.raises(NotImplementedError):
            g[torch.eye(4, dtype=torch.bool, device="meta")] += 1.0

    def test_factor_adds_sigma_on_the_global_diagonal(self):
        """The diagonal add of the factor (a strided view, no mask) hits
        exactly the padded Gram's diagonal, pad block included."""
        mesh = mesh_lib.make_cpu_mesh(8)
        be = ShardedBackend(21, mesh, block_size=8)
        A, b = _problem(n=64, d=21)
        be.fuse(tcore.compute_stats(A, b))
        L = be.factor(0.5).L.full().double()
        G = be.gram.full().double() + 0.5 * torch.eye(be.padded, dtype=torch.float64)
        assert float(torch.linalg.norm(L @ L.T - G) / torch.linalg.norm(G)) <= 1e-6
        assert torch.equal(distributed.ShardedBackend._block(be, G, 3, 1),
                           G[3 * be._rl:4 * be._rl, be._cl:2 * be._cl].float())
