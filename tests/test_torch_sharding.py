"""Port parity for ``launch/sharding.py`` and ``launch/mesh.py``.

``ShardingRules.resolve`` is held to the reference's on every rule table,
against the same abstract meshes (tests/test_substrate.py's 16 x 16 and
2 x 16 x 16, plus the (4, 2) test mesh): the same logical specs and shapes
give the same mesh axes, entry by entry. The port's meshes are grids of
``torch.device``s that may repeat; their factorization, ``client_axes`` and
the collectives (added in flat shard order, so bitwise a left fold) are
checked here too, as is ``ShardedTensor``'s layout.
"""
import itertools

import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh as JAbstractMesh
from jax.sharding import PartitionSpec as JP

from repro.launch import mesh as jmesh_lib
from repro.launch import sharding as jsharding
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import sharding

TABLES = ("DEFAULT_RULES", "FUSION_RULES", "ZERO1_PARAM_RULES",
          "STACK_FSDP_RULES", "DECODE_RULES")
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "4x2": ((4, 2), ("data", "model"))}
DIMS = (1, 2, 4, 8, 16, 24, 32, 48, 128, 256, 8192, 29568)


def _jmesh(shape, axes):
    try:
        return JAbstractMesh(shape, axes)
    except TypeError:  # jax<=0.4 signature: tuple of (name, size) pairs
        return JAbstractMesh(tuple(zip(axes, shape)))


def _cases(table, seed, n=300):
    """Logical specs over the table's names (and None / unknown names) with
    shapes from DIMS, made from a seed."""
    rng = np.random.default_rng(seed)
    names = sorted(table.rules) + [None, "no_such_axis"]
    out = []
    for _ in range(n):
        ndim = int(rng.integers(1, 5))
        logical = tuple(names[int(rng.integers(len(names)))] for _ in range(ndim))
        shape = tuple(int(DIMS[int(rng.integers(len(DIMS)))]) for _ in range(ndim))
        out.append((logical, shape))
    return out


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("table_name", TABLES)
def test_resolve_matches_reference(table_name, mesh_name):
    shape, axes = MESHES[mesh_name]
    jt, tt = getattr(jsharding, table_name), getattr(sharding, table_name)
    jm, tm = _jmesh(shape, axes), mesh_lib.make_mesh(shape, axes, device="meta")
    assert {k: tuple(v) for k, v in tt.rules.items()} == \
        {k: tuple(v) for k, v in jt.rules.items()}
    for logical, dims in _cases(jt, seed=TABLES.index(table_name)):
        want = jt.resolve(JP(*logical), dims, jm)
        got = tt.resolve(sharding.P(*logical), dims, tm)
        assert tuple(got) == tuple(want), (logical, dims)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_batch_axes_and_gram_axes_resolve_as_reference(mesh_name):
    shape, axes = MESHES[mesh_name]
    jm, tm = _jmesh(shape, axes), mesh_lib.make_mesh(shape, axes, device="meta")
    assert tuple(sharding.GRAM_AXES) == tuple(jsharding.GRAM_AXES)
    assert sharding.BATCH_AXES.keys() == jsharding.BATCH_AXES.keys()
    for mode, specs in jsharding.BATCH_AXES.items():
        for key, jspec in specs.items():
            tspec = sharding.BATCH_AXES[mode][key]
            assert tuple(tspec) == tuple(jspec)
            dims = (256, 4096, 1280)[:len(jspec)]
            assert tuple(sharding.DEFAULT_RULES.resolve(tspec, dims, tm)) == \
                tuple(jsharding.DEFAULT_RULES.resolve(jspec, dims, jm))
    n = int(np.prod(shape))
    assert tuple(sharding.FUSION_RULES.resolve(sharding.GRAM_AXES, (n, n), tm)) \
        == tuple(jsharding.FUSION_RULES.resolve(jsharding.GRAM_AXES, (n, n), jm))


class TestSubstrateCases:
    """tests/test_substrate.py's resolve cases, on the port."""

    def _mesh(self, multi=False):
        shape = (2, 16, 16) if multi else (16, 16)
        axes = ("pod", "data", "model") if multi else ("data", "model")
        return mesh_lib.make_mesh(shape, axes, device="meta")

    def test_param_2d_sharding(self):
        spec = sharding.DEFAULT_RULES.resolve(sharding.P("embed", "ff"),
                                              (8192, 29568), self._mesh())
        assert spec == sharding.P("data", "model")

    def test_kv_heads_fallback_to_head_dim(self):
        spec = sharding.DEFAULT_RULES.resolve(
            sharding.P("batch", "seq_cache", "kv_heads", "head_dim"),
            (128, 32768, 8, 128), self._mesh())
        assert spec == sharding.P("data", None, None, "model")

    def test_batch_composite_multipod(self):
        spec = sharding.DEFAULT_RULES.resolve(sharding.P("batch", "seq"),
                                              (256, 4096), self._mesh(multi=True))
        assert spec == sharding.P(("pod", "data"), None)

    def test_no_axis_reuse(self):
        spec = sharding.DEFAULT_RULES.resolve(sharding.P("batch", "seq", "embed"),
                                              (32, 32768, 1280), self._mesh())
        assert spec == sharding.P("data", None, None)


class TestMeshes:
    @pytest.mark.parametrize("n", range(1, 17))
    def test_most_square_factorization(self, n):
        m = mesh_lib.make_cpu_mesh(n)
        r, c = m.devices.shape
        assert r * c == n and r >= c
        # the reference's rule, as make_cpu_mesh computes it
        cols = max(c for c in range(1, int(n ** 0.5) + 1) if n % c == 0)
        assert (r, c) == (n // cols, cols)
        assert m.axis_names == ("data", "model")
        assert m.shape == {"data": n // cols, "model": cols}

    def test_eight_is_four_by_two_with_repeated_devices(self):
        m = mesh_lib.make_cpu_mesh(8)
        assert m.shape == {"data": 4, "model": 2} and m.size == 8
        assert m.distinct_devices == [torch.device("cpu")]
        card = mesh_lib.make_device_mesh(8, device="meta")
        assert card.shape == m.shape and card.distinct_devices == [torch.device("meta")]

    def test_one_device_matches_reference_degraded_mesh(self):
        """The reference on this one-device process gives a 1 x 1 mesh for
        make_cpu_mesh(1); the port's is the same shape."""
        jm = jmesh_lib.make_cpu_mesh(1)
        tm = mesh_lib.make_cpu_mesh(1)
        assert tuple(jm.devices.shape) == tuple(tm.devices.shape)
        assert tuple(jm.axis_names) == tm.axis_names

    @pytest.mark.parametrize("axes", [("data", "model"), ("pod", "data", "model"),
                                      ("model",), ("x", "y")])
    def test_client_axes_as_reference(self, axes):
        shape = (2, 2, 2)[:len(axes)]
        jm = _jmesh(shape, axes)
        tm = mesh_lib.make_mesh(shape, axes, device="cpu")
        assert mesh_lib.client_axes(tm) == jmesh_lib.client_axes(jm)

    def test_host_mesh_shape_and_bad_names(self):
        m = mesh_lib.make_host_mesh((2, 4), ("data", "model"))
        assert m.shape == {"data": 2, "model": 4}
        with pytest.raises(ValueError, match="axis names"):
            mesh_lib.make_mesh((2, 2), ("data",), device="cpu")
        with pytest.raises(ValueError, match="repeated"):
            mesh_lib.make_mesh((2, 2), ("data", "data"), device="cpu")

    def test_unflatten_is_row_major(self):
        m = mesh_lib.make_mesh((2, 3, 2), ("pod", "data", "model"), device="cpu")
        seen = [mesh_lib.unflatten(m, ("pod", "data"), k) for k in range(6)]
        assert seen == [{"pod": p, "data": d} for p in range(2) for d in range(3)]
        assert mesh_lib.axis_size(m, ("pod", "data")) == 6
        assert mesh_lib.axis_size(m, ()) == 1


class TestCollectives:
    def _parts(self, k=5, seed=0):
        rng = np.random.default_rng(seed)
        return [torch.from_numpy(rng.standard_normal((6, 4)).astype(np.float32))
                for _ in range(k)]

    def test_psum_is_a_left_fold_in_shard_order(self):
        parts = self._parts()
        want = parts[0]
        for p in parts[1:]:
            want = want + p
        assert torch.equal(mesh_lib.psum(parts), want)
        # the order is part of the contract: repeatable bit for bit
        assert torch.equal(mesh_lib.psum(parts), mesh_lib.psum(list(parts)))

    def test_all_gather_and_psum_scatter(self):
        parts = self._parts(k=3)
        assert torch.equal(mesh_lib.all_gather(parts), torch.cat(parts))
        assert torch.equal(mesh_lib.all_gather(parts, dim=1), torch.cat(parts, 1))
        sl = mesh_lib.psum_scatter(parts, dim=0)
        total = mesh_lib.psum(parts)
        assert len(sl) == 3
        assert torch.equal(torch.cat(sl), total)
        with pytest.raises(ValueError, match="does not split"):
            mesh_lib.psum_scatter(self._parts(k=4), dim=0)

    @pytest.mark.parametrize("dim", [0, 1])
    def test_psum_scatter_on_a_repeated_device_mesh(self, dim):
        # every shard on the one cpu device: slice i of the sum, its values
        # and its device unchanged by the placement on shard i's device
        parts = [torch.from_numpy(p) for p in np.random.default_rng(3).standard_normal(
            (4, 8, 8)).astype(np.float32)]
        devices = mesh_lib.make_cpu_mesh(4).devices.reshape(-1)
        assert all(p.device == d for p, d in zip(parts, devices))
        total = mesh_lib.psum(parts)
        for device in (None, "cpu"):
            sl = mesh_lib.psum_scatter(parts, device=device, dim=dim)
            assert len(sl) == 4
            for i, s in enumerate(sl):
                assert s.device == parts[i].device
                assert torch.equal(s, torch.chunk(total, 4, dim=dim)[i])
                # no copy: every slice is a view of the one sum
                assert s.untyped_storage().data_ptr() == sl[0].untyped_storage().data_ptr()


class TestShardedTensor:
    @pytest.mark.parametrize("spec", [("data", "model"), ("data", None),
                                      (None, "model"), (None, None),
                                      (("data", "model"), None)])
    def test_distribute_then_full_is_bitwise(self, spec):
        m = mesh_lib.make_cpu_mesh(8)
        x = torch.from_numpy(np.random.default_rng(1).standard_normal((16, 8))
                             .astype(np.float32))
        st = sharding.ShardedTensor.distribute(x, m, spec)
        assert torch.equal(st.full(), x)
        counts = sharding.ShardedTensor.grid(m, spec, x.shape)
        assert len(st.blocks) == int(np.prod(counts))
        assert st.nbytes == x.numel() * 4
        for index, blk in st.blocks.items():
            assert tuple(blk.shape) == (16 // counts[0], 8 // counts[1])

    def test_indivisible_dimension_raises(self):
        m = mesh_lib.make_cpu_mesh(8)
        with pytest.raises(ValueError, match="does not split"):
            sharding.ShardedTensor.distribute(torch.zeros(6, 6), m, ("data", None))
